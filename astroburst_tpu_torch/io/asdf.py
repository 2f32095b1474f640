"""ASDF reader (JWST/Roman datamodels): its own copy of
astroburst_tpu/io/asdf.py.

Reference: src-tauri/src/infra/asdf/ — YAML tree parse with unknown
tags tolerated, binary block magic 0xd3 'BLK' + big-endian header,
zlib/bzip2/lz4 decompression, ndarray dtype/byteorder/shape metadata,
WCS + gWCS extraction, data-array discovery including Roman datamodel
paths and a depth-4 deep search; and infra/asdf_bridge.rs — the
FITS-like header synthesis.

The YAML tree is parsed with PyYAML, imported inside ``_parse_tree``
and never when this module is imported: the package imports where
PyYAML is missing, and reading an ASDF file there raises
ModuleNotFoundError naming PyYAML. That error is not an AsdfError, so
``extract_image_from_asdf`` does not take it for a malformed file and
does not fall back to a companion FITS file.
"""

from __future__ import annotations

import bz2
import os
import re
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from astroburst_tpu_torch.errors import AsdfError
from astroburst_tpu_torch.io.fits_reader import extract_image
from astroburst_tpu_torch.io.header import HduHeader

ASDF_MAGIC = b"#ASDF"
BLOCK_MAGIC = b"\xd3BLK"
_DATA_CANDIDATES = ("data", "sci", "SCI", "science", "image")


def _parse_tree(text: str) -> dict:
    """The YAML tree, with ASDF's !core/ndarray-style tags mapped to
    plain mappings, sequences and scalars."""
    try:
        import yaml
    except ImportError as e:
        raise ModuleNotFoundError(
            "reading an ASDF file needs PyYAML (the 'yaml' module), which "
            "is not installed", name="yaml") from e

    class TagTolerantLoader(yaml.SafeLoader):
        pass

    def any_tag(loader, tag_suffix, node):
        if isinstance(node, yaml.MappingNode):
            return loader.construct_mapping(node, deep=True)
        if isinstance(node, yaml.SequenceNode):
            return loader.construct_sequence(node, deep=True)
        return loader.construct_scalar(node)

    TagTolerantLoader.add_multi_constructor("!", any_tag)
    TagTolerantLoader.add_multi_constructor("tag:", any_tag)
    try:
        return yaml.load(text, Loader=TagTolerantLoader) or {}
    except yaml.YAMLError as e:
        raise AsdfError(f"YAML tree parse failed: {e}")


_DTYPES = {
    "float32": ("f4", 4), "float64": ("f8", 8),
    "int8": ("i1", 1), "uint8": ("u1", 1),
    "int16": ("i2", 2), "uint16": ("u2", 2),
    "int32": ("i4", 4), "uint32": ("u4", 4),
    "int64": ("i8", 8), "uint64": ("u8", 8),
}


@dataclass
class NdArrayMeta:
    source: int
    shape: List[int]
    dtype: str       # numpy letter code, e.g. "f4"
    byteorder: str   # "<" or ">"

    @staticmethod
    def from_node(node: dict) -> "NdArrayMeta":
        if "source" not in node:
            raise AsdfError("Missing field: source")
        if "shape" not in node:
            raise AsdfError("Missing field: shape")
        dtype_str = str(node.get("datatype", "float32")).lower()
        byteorder = str(node.get("byteorder", "big")).lower()
        if dtype_str not in _DTYPES:
            raise AsdfError(f"Unsupported ASDF dtype: {dtype_str}")
        order = "<" if byteorder in ("little", "<") else ">"
        return NdArrayMeta(source=int(node["source"]),
                           shape=[int(s) for s in node["shape"]],
                           dtype=_DTYPES[dtype_str][0], byteorder=order)

    def expected_byte_size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n * int(self.dtype[1])


@dataclass
class WcsInfo:
    crpix: Tuple[float, float]
    crval: Tuple[float, float]
    cdelt: Tuple[float, float]
    pc: Tuple[Tuple[float, float], Tuple[float, float]]
    ctype: Tuple[str, str]
    cunit: Tuple[str, str]

    @staticmethod
    def _pair(node, key):
        v = node.get(key)
        if isinstance(v, (list, tuple)) and len(v) >= 2:
            try:
                return (float(v[0]), float(v[1]))
            except (TypeError, ValueError):
                return None
        return None

    @staticmethod
    def from_tree(tree: dict) -> Optional["WcsInfo"]:
        wcs = tree.get("wcs")
        if wcs is None and isinstance(tree.get("meta"), dict):
            wcs = tree["meta"].get("wcs")
        if not isinstance(wcs, dict):
            return None
        crpix = WcsInfo._pair(wcs, "crpix")
        crval = WcsInfo._pair(wcs, "crval")
        if crpix is None or crval is None:
            return None
        cdelt = WcsInfo._pair(wcs, "cdelt") or (1.0, 1.0)
        pc_node = wcs.get("pc")
        pc = ((1.0, 0.0), (0.0, 1.0))
        if (isinstance(pc_node, (list, tuple)) and len(pc_node) >= 2 and
                all(isinstance(r, (list, tuple)) and len(r) >= 2
                    for r in pc_node[:2])):
            pc = ((float(pc_node[0][0]), float(pc_node[0][1])),
                  (float(pc_node[1][0]), float(pc_node[1][1])))
        ctype = tuple(str(c) for c in (wcs.get("ctype") or
                                       ["RA---TAN", "DEC--TAN"])[:2])
        cunit = tuple(str(c) for c in (wcs.get("cunit") or
                                       ["deg", "deg"])[:2])
        return WcsInfo(crpix, crval, cdelt, pc, ctype, cunit)

    @staticmethod
    def from_gwcs(tree: dict) -> Optional["WcsInfo"]:
        """Best-effort gWCS step walk (tree.rs:138+): pick up shift
        (→CRPIX), affine/scale (→PC/CDELT) and the celestial frame
        reference (→CRVAL)."""
        gwcs = tree.get("gwcs")
        if gwcs is None and isinstance(tree.get("meta"), dict):
            w = tree["meta"].get("wcs")
            if isinstance(w, dict) and "steps" in w:
                gwcs = w
        if not isinstance(gwcs, dict):
            return None
        steps = gwcs.get("steps")
        if not isinstance(steps, (list, tuple)):
            return None
        crpix = [0.0, 0.0]
        crval = [0.0, 0.0]
        cdelt = [1.0, 1.0]
        pc = [[1.0, 0.0], [0.0, 1.0]]

        def walk(t):
            if not isinstance(t, dict):
                return
            ttype = str(t.get("transform_type") or t.get("type") or "")
            if "shift" in ttype.lower() and "offset" in t:
                offs = t.get("offset")
                if isinstance(offs, (int, float)):
                    crpix[0] = -float(offs)
            if "forward" in t and isinstance(t["forward"], (list, tuple)):
                for sub in t["forward"]:
                    walk(sub)
            if "lon" in t and "lat" in t:
                try:
                    crval[0] = float(t["lon"])
                    crval[1] = float(t["lat"])
                except (TypeError, ValueError):
                    pass

        for step in steps:
            if isinstance(step, dict):
                frame = step.get("frame")
                if isinstance(frame, dict):
                    ref = frame.get("reference_frame")
                    if isinstance(ref, dict):
                        walk(ref)
                walk(step.get("transform"))
        return WcsInfo(tuple(crpix), tuple(crval), tuple(cdelt),
                       (tuple(pc[0]), tuple(pc[1])),
                       ("RA---TAN", "DEC--TAN"), ("deg", "deg"))


@dataclass
class AsdfFile:
    version: str
    standard_version: Optional[str]
    tree: dict
    blocks: List[bytes]


def lz4_block_decompress(src: bytes, expected_size: int) -> bytes:
    """Raw LZ4 block decode (no frame header), vendored so lz4 ASDF
    blocks need no third-party package.

    Matches the reference's lz4_flex::decompress(raw, data_size)
    (infra/asdf/blocks.rs:135-139): sequences of
    [token][ext lit len][literals][2-byte LE offset][ext match len],
    match copies may overlap (RLE-style).
    """
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise AsdfError("lz4: truncated block in literal "
                                    "length extension")
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise AsdfError("lz4: literal run past end of block")
        out += src[i:i + lit]
        i += lit
        if i >= n:
            break  # final sequence carries no match
        if i + 2 > n:
            raise AsdfError("lz4: truncated match offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise AsdfError(f"lz4: invalid match offset {offset}")
        mlen = token & 0xF
        if mlen == 15:
            while True:
                if i >= n:
                    raise AsdfError("lz4: truncated block in match "
                                    "length extension")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - offset
        if offset >= mlen:
            out += out[start:start + mlen]
        else:  # overlapping match: repeat the trailing pattern
            seg = out[start:]
            reps = -(-mlen // offset)
            out += (seg * reps)[:mlen]
    if expected_size and len(out) != expected_size:
        raise AsdfError(
            f"lz4: decompressed {len(out)} bytes, expected "
            f"{expected_size}")
    return bytes(out)


def _decompress(comp: bytes, data: bytes,
                expected_size: int = 0) -> bytes:
    tag = comp.rstrip(b"\0")
    if tag in (b"", b"none"):
        return data
    if tag == b"zlib":
        return zlib.decompress(data)
    if tag == b"bzp2":
        return bz2.decompress(data)
    if tag == b"lz4":
        return lz4_block_decompress(data, expected_size)
    raise AsdfError(f"Unknown ASDF block compression: {tag!r}")


def open_asdf(path: str) -> AsdfFile:
    with open(path, "rb") as f:
        raw = f.read()
    if not raw.startswith(ASDF_MAGIC):
        raise AsdfError("Invalid ASDF magic")
    # preamble: '#ASDF x.y.z' [+ '#ASDF_STANDARD a.b.c'] + comments
    first_nl = raw.find(b"\n")
    version = raw[len(ASDF_MAGIC):first_nl].strip().decode("ascii", "replace")
    standard = None
    m = re.search(rb"#ASDF_STANDARD ([^\n]+)", raw[:4096])
    if m:
        standard = m.group(1).strip().decode("ascii", "replace")

    # YAML document: from '--- ' (or right after preamble) to '\n...'
    yaml_start = raw.find(b"%YAML")
    if yaml_start == -1:
        yaml_start = raw.find(b"---")
    first_block = raw.find(BLOCK_MAGIC)
    yaml_end = raw.find(b"\n...", 0 if yaml_start == -1 else yaml_start)
    if yaml_end == -1:
        yaml_end = first_block if first_block != -1 else len(raw)
    tree = {}
    if yaml_start != -1 and yaml_start < yaml_end:
        tree = _parse_tree(raw[yaml_start:yaml_end].decode("utf-8",
                                                            "replace"))

    # binary blocks (blocks.rs:32-101)
    blocks: List[bytes] = []
    pos = first_block
    while pos != -1 and pos + 6 <= len(raw):
        if raw[pos:pos + 4] != BLOCK_MAGIC:
            break
        header_size = struct.unpack(">H", raw[pos + 4:pos + 6])[0]
        h = raw[pos + 6:pos + 6 + header_size]
        if len(h) < 48:
            raise AsdfError("Invalid ASDF block header")
        compression = h[4:8]
        allocated = struct.unpack(">Q", h[8:16])[0]
        used = struct.unpack(">Q", h[16:24])[0]
        data_size = struct.unpack(">Q", h[24:32])[0]
        data_start = pos + 6 + header_size
        data = raw[data_start:data_start + used]
        blocks.append(_decompress(compression, data, data_size))
        pos = data_start + max(allocated, used)
        if raw[pos:pos + 4] != BLOCK_MAGIC:
            nxt = raw.find(BLOCK_MAGIC, pos)
            pos = nxt
    return AsdfFile(version, standard, tree, blocks)


def _find_data_array(tree: dict) -> Tuple[str, dict]:
    """converter.rs:60-116 discovery chain."""
    def is_nd(node):
        return isinstance(node, dict) and "source" in node and "shape" in node

    if isinstance(tree, dict):
        for key in _DATA_CANDIDATES:
            node = tree.get(key)
            if is_nd(node):
                return key, node
            if isinstance(node, dict) and is_nd(node.get("data")):
                return key, node["data"]
        roman = tree.get("roman")
        if isinstance(roman, dict):
            for rp in ("data", "science", "sci"):
                if is_nd(roman.get(rp)):
                    return f"roman.{rp}", roman[rp]

        def deep(node, depth):
            if depth > 4:
                return None
            if is_nd(node):
                return node
            if isinstance(node, dict):
                for v in node.values():
                    found = deep(v, depth + 1)
                    if found is not None:
                        return found
            return None

        for k, v in tree.items():
            found = deep(v, 0)
            if found is not None:
                return str(k), found
    raise AsdfError("Missing field: data array")


def _flatten(val, prefix: str, out: Dict[str, str]) -> None:
    if isinstance(val, dict):
        for k, v in val.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            _flatten(v, key, out)
    elif isinstance(val, (list, tuple)):
        out[prefix] = ",".join(str(x) for x in val[:8])
    else:
        out[prefix] = str(val)


@dataclass
class AsdfImage:
    width: int
    height: int
    channels: int
    data: np.ndarray        # f32 [H, W] (first plane if multi-channel)
    wcs: Optional[WcsInfo]
    metadata: Dict[str, str]
    header: HduHeader = field(default_factory=HduHeader)
    image: np.ndarray = None  # alias of data for bridge compat

    def __post_init__(self):
        if self.image is None:
            self.image = self.data


def _interpret_shape(shape: List[int]) -> Tuple[int, int, int]:
    """converter.rs:196-208."""
    if len(shape) == 2:
        return shape[0], shape[1], 1
    if len(shape) == 3:
        if shape[0] <= 4:
            return shape[1], shape[2], shape[0]
        if shape[2] <= 4:
            return shape[0], shape[1], shape[2]
        return shape[1], shape[2], shape[0]
    total = 1
    for s in shape:
        total *= s
    side = int(total ** 0.5)
    return side, side, 1


def _synthesize_header(img_w: int, img_h: int, wcs: Optional[WcsInfo],
                       metadata: Dict[str, str]) -> HduHeader:
    """asdf_bridge.rs:16-70 FITS-like header."""
    header = HduHeader()
    header.set("NAXIS", "2")
    header.set("NAXIS1", str(img_w))
    header.set("NAXIS2", str(img_h))
    header.set("BITPIX", "-32")
    if wcs is not None:
        for k, v in (("CRPIX1", wcs.crpix[0]), ("CRPIX2", wcs.crpix[1]),
                     ("CRVAL1", wcs.crval[0]), ("CRVAL2", wcs.crval[1]),
                     ("CDELT1", wcs.cdelt[0]), ("CDELT2", wcs.cdelt[1]),
                     ("PC1_1", wcs.pc[0][0]), ("PC1_2", wcs.pc[0][1]),
                     ("PC2_1", wcs.pc[1][0]), ("PC2_2", wcs.pc[1][1])):
            header.set(k, str(v))
        header.set("CTYPE1", wcs.ctype[0])
        header.set("CTYPE2", wcs.ctype[1])
        header.set("CUNIT1", wcs.cunit[0])
        header.set("CUNIT2", wcs.cunit[1])
    for k, v in metadata.items():
        fits_key = k.replace(".", "_").upper()[:68]
        if fits_key not in header:
            header.set(fits_key, v)
    header.set("ASDF_SRC", "true")
    return header


def load_asdf_image(path: str) -> AsdfImage:
    asdf = open_asdf(path)
    key, node = _find_data_array(asdf.tree)
    meta = NdArrayMeta.from_node(node)
    if meta.source >= len(asdf.blocks):
        raise AsdfError(f"Missing block {meta.source}")
    raw = asdf.blocks[meta.source]
    dt = np.dtype(meta.byteorder + meta.dtype)
    count = meta.expected_byte_size() // dt.itemsize
    pixels = np.frombuffer(raw[:count * dt.itemsize], dtype=dt).astype(
        np.float32)
    height, width, channels = _interpret_shape(meta.shape)
    plane = pixels[:width * height].reshape(height, width)

    wcs = WcsInfo.from_tree(asdf.tree) or WcsInfo.from_gwcs(asdf.tree)
    metadata: Dict[str, str] = {}
    for mkey, prefix in (("meta", "meta"), ("header", "header")):
        if isinstance(asdf.tree.get(mkey), dict):
            _flatten(asdf.tree[mkey], prefix, metadata)
    roman = asdf.tree.get("roman")
    if isinstance(roman, dict) and isinstance(roman.get("meta"), dict):
        _flatten(roman["meta"], "roman.meta", metadata)
    metadata["ASDF_DATA_KEY"] = key

    header = _synthesize_header(width, height, wcs, metadata)
    return AsdfImage(width=width, height=height, channels=channels,
                     data=plane, wcs=wcs, metadata=metadata, header=header)


def extract_image_from_asdf(path: str) -> AsdfImage:
    """Companion-FITS fallback preserved (asdf_bridge.rs:10)."""
    try:
        return load_asdf_image(path)
    except AsdfError:
        companion = os.path.splitext(path)[0] + ".fits"
        if os.path.exists(companion):
            fi = extract_image(companion)
            return AsdfImage(width=fi.image.shape[1],
                             height=fi.image.shape[0], channels=1,
                             data=fi.image, wcs=None, metadata={},
                             header=fi.header)
        raise
