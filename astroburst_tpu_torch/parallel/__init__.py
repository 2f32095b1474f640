"""Meshes and the pipelines over them (counterpart of
astroburst_tpu/parallel): the single-device align → stack → stretch,
and its sharded step over a (frames, rows) mesh of torch devices."""

from astroburst_tpu_torch.parallel.mesh import make_mesh
from astroburst_tpu_torch.parallel.pipeline import (align_stack_stretch,
                                                    make_sharded_stack_step)

__all__ = ["make_mesh", "align_stack_stretch", "make_sharded_stack_step"]
