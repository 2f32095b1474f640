"""Compose-wizard domain model: steps, enablement, invalidation,
channel-path resolution (its own copy of
astroburst_tpu/metadata/wizard.py).

Reference behavior: src/utils/wizard.ts:217-315 (11 steps with
enablement rules and badges), :319-350 (downstream invalidation),
:364-409 (channel path resolution through background→crop→align→stack
with raw-file fallback, and RGB candidate assignment), :196-215
(narrowband workflow detection). The reference keeps this in the
TypeScript frontend; here it is a headless state machine so any client
of the API layer gets the same step flow.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional

from astroburst_tpu_torch.metadata.presets import BLEND_PRESETS, DEFAULT_BINS

NARROWBAND_BIN_IDS = frozenset({"ha", "sii", "nii", "oiii", "hb"})
NARROWBAND_PRESETS = frozenset(
    {"sho", "hoo", "dynamic_hoo", "foraxx", "hubble_legacy"})
NARROWBAND_FILTER_LABELS = frozenset(
    {"Hα (656nm)", "[OIII] (502nm)", "[SII] (673nm)"})


@dataclass
class WizardState:
    """Mutable wizard session state (wizard.ts:38-68 WizardState)."""
    bins: Dict[str, List[str]] = field(
        default_factory=lambda: {b["id"]: [] for b in DEFAULT_BINS})
    stacked_paths: Dict[str, str] = field(default_factory=dict)
    aligned_paths: Dict[str, str] = field(default_factory=dict)
    cropped_paths: Dict[str, str] = field(default_factory=dict)
    background_paths: Dict[str, str] = field(default_factory=dict)
    blend_preset: str = "sho"
    composite_ready: bool = False
    wb_mode: str = "auto"
    stretch_mode: str = "masked"
    target_background: float = 0.25
    linked_stf: bool = True
    completed_steps: Dict[str, bool] = field(default_factory=dict)

    def filled_count(self) -> int:
        return sum(1 for files in self.bins.values() if files)

    def total_files(self) -> int:
        return sum(len(files) for files in self.bins.values())


@dataclass(frozen=True)
class StepDef:
    id: str
    label: str
    short_label: str
    enabled: Callable[[WizardState], bool]
    badge: Optional[Callable[[WizardState], Optional[str]]] = None


def _count_badge(getter):
    def badge(s: WizardState):
        n = len(getter(s))
        return str(n) if n else None
    return badge


STEPS: List[StepDef] = [
    StepDef("channels", "Channel Assignment", "Channels",
            lambda s: True,
            lambda s: str(s.total_files()) if s.total_files() else None),
    StepDef("stack", "Stacking", "Stack",
            lambda s: any(len(f) > 1 for f in s.bins.values()),
            _count_badge(lambda s: s.stacked_paths)),
    StepDef("align", "Channel Alignment", "Align",
            lambda s: s.filled_count() >= 2),
    StepDef("crop", "Crop", "Crop",
            lambda s: bool(s.aligned_paths),
            _count_badge(lambda s: s.cropped_paths)),
    StepDef("background", "Background Extraction", "BG",
            lambda s: bool(s.aligned_paths) or bool(s.cropped_paths)
            or s.total_files() > 0,
            _count_badge(lambda s: s.background_paths)),
    StepDef("blend", "Channel Blending", "Blend",
            lambda s: s.filled_count() >= 2,
            lambda s: "✓" if s.composite_ready else None),
    StepDef("colorbalance", "Color Balance", "Color",
            lambda s: s.composite_ready or s.filled_count() >= 2),
    StepDef("mask", "Star Mask", "Mask",
            lambda s: s.total_files() > 0),
    StepDef("stretch", "Stretch", "Stretch",
            lambda s: s.composite_ready or s.total_files() > 0),
    StepDef("adjust", "Adjust", "Adjust",
            lambda s: s.composite_ready),
    StepDef("export", "Export", "Export", lambda s: True),
]

STEP_ORDER = [s.id for s in STEPS]
_STEP_INDEX = {s.id: i for i, s in enumerate(STEPS)}


def invalidate_from_step(completed: Dict[str, bool],
                         from_step: str) -> Dict[str, bool]:
    """Clear completion flags for `from_step` and everything after it
    (wizard.ts:319-330)."""
    idx = _STEP_INDEX.get(from_step)
    if idx is None:
        return dict(completed)
    keep = set(STEP_ORDER[:idx])
    return {k: v for k, v in completed.items() if k in keep}


def invalidate_downstream(state: WizardState, from_step: str) -> WizardState:
    """Redoing a step discards every downstream artifact
    (wizard.ts:332-350): align/crop/background paths and the composite
    flag, depending on where the change happened."""
    idx = _STEP_INDEX.get(from_step)
    if idx is None:
        return state
    new = replace(state,
                  completed_steps=invalidate_from_step(
                      state.completed_steps, from_step))

    def after(step_id: str) -> bool:
        return _STEP_INDEX[step_id] > idx

    if after("align"):
        new.aligned_paths = {}
    if after("crop"):
        new.cropped_paths = {}
    if after("background"):
        new.background_paths = {}
    if after("blend"):
        new.composite_ready = False
    return new


def next_enabled_step(state: WizardState, current: str) -> Optional[str]:
    """First enabled step after `current` (wizard.ts:352-361)."""
    idx = _STEP_INDEX.get(current, -1)
    for step in STEPS[idx + 1:]:
        if step.enabled(state):
            return step.id
    return None


def resolve_channel_path(state: WizardState, bin_id: str) -> Optional[str]:
    """Most-processed artifact for a bin: background → crop → align →
    stack → first raw file (wizard.ts:364-372)."""
    for paths in (state.background_paths, state.cropped_paths,
                  state.aligned_paths, state.stacked_paths):
        if bin_id in paths:
            return paths[bin_id]
    files = state.bins.get(bin_id) or []
    return files[0] if files else None


def resolve_any_channel_path(state: WizardState) -> Optional[str]:
    """First resolvable channel in bin order (wizard.ts:374-383)."""
    for bin_id in state.bins:
        p = resolve_channel_path(state, bin_id)
        if p is not None:
            return p
    return None


def resolve_rgb_paths(state: WizardState) -> Dict[str, Optional[str]]:
    """Assign active bins to R/G/B slots by candidate priority
    (wizard.ts:385-409): R←[r, sii, ha], G←[g, ha, oiii],
    B←[b, oiii, sii]; each bin used once, except B may reuse one if
    nothing is left."""
    active = {b for b, files in state.bins.items() if files}
    used: set = set()

    def find_best(candidates, allow_reuse=False):
        for cid in candidates:
            if not allow_reuse and cid in used:
                continue
            if cid in active:
                used.add(cid)
                return resolve_channel_path(state, cid)
        return None

    r = find_best(["r", "sii", "ha"])
    g = find_best(["g", "ha", "oiii"])
    b = find_best(["b", "oiii", "sii"])
    if b is None:
        b = find_best(["b", "oiii", "sii"], allow_reuse=True)
    return {"r": r, "g": g, "b": b}


def is_narrowband_workflow(state: WizardState,
                           filter_detections=None) -> bool:
    """True when any filled bin is narrowband, the preset is a
    narrowband preset, or an assigned file was detected as a
    narrowband filter (wizard.ts:196-215)."""
    filled = {b for b, files in state.bins.items() if files}
    if filled & NARROWBAND_BIN_IDS:
        return True
    if state.blend_preset in NARROWBAND_PRESETS:
        return True
    if filter_detections:
        assigned = {f for files in state.bins.values() for f in files}
        for det in filter_detections:
            if (det.get("filter") in NARROWBAND_FILTER_LABELS
                    and det.get("path") in assigned):
                return True
    return False


def initial_state() -> WizardState:
    """Fresh state matching wizard.ts:136-168 INITIAL_STATE (the
    default preset is SHO)."""
    assert "sho" in BLEND_PRESETS
    return WizardState()
