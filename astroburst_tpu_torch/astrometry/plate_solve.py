"""Plate solving via the astrometry.net web API (its own copy of
astroburst_tpu/astrometry/plate_solve.py).

Reference: src-tauri/src/infra/astrometry/plate_solve.rs (login /
upload / poll client, WCS-key whitelist incl. SIP polynomials,
annotation parse) and src-tauri/src/core/astrometry/plate_solve.rs
(SolveResult/SolveConfig types, offline placeholder).

The client speaks HTTP through ``urllib.request.urlopen`` with the JAX
package's requests, byte for byte, and its error texts. Offline, the
first request fails and the client raises ``SolveError``
("astrometry.net unreachable: ..."). As in the JAX package,
``filter_wcs_keys`` is defined but not called, so
``SolveResult.wcs_headers`` stays empty (ROADMAP C33).
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from astroburst_tpu_torch.constants import DEFAULT_ASTROMETRY_API_URL
from astroburst_tpu_torch.errors import SolveError

# WCS keys worth keeping from a solution (infra plate_solve.rs:19-42)
WCS_KEY_WHITELIST_PREFIXES = (
    "CRPIX", "CRVAL", "CDELT", "CTYPE", "CUNIT", "CROTA",
    "CD1_", "CD2_", "PC1_", "PC2_",
    "LONPOLE", "LATPOLE", "RADESYS", "EQUINOX", "EPOCH",
    "A_", "B_", "AP_", "BP_", "A_ORDER", "B_ORDER",
    "WCSAXES", "IMAGEW", "IMAGEH",
)


@dataclass
class SolveConfig:
    api_url: str = DEFAULT_ASTROMETRY_API_URL
    api_key: str = ""
    ra_hint: Optional[float] = None
    dec_hint: Optional[float] = None
    radius_hint: Optional[float] = 10.0
    scale_low: Optional[float] = None
    scale_high: Optional[float] = None
    max_stars: Optional[int] = 100
    timeout_secs: int = 120


@dataclass
class FieldAnnotation:
    kind: str
    names: List[str]
    pixelx: float
    pixely: float
    radius: Optional[float] = None

    def to_dict(self) -> dict:
        return {"type": self.kind, "names": self.names,
                "pixelx": self.pixelx, "pixely": self.pixely,
                "radius": self.radius}


@dataclass
class SolveResult:
    success: bool
    ra_center: float
    dec_center: float
    orientation: float
    pixel_scale: float
    field_w_arcmin: float
    field_h_arcmin: float
    index_name: str
    stars_used: int
    wcs_headers: Dict[str, str] = field(default_factory=dict)
    annotations: List[FieldAnnotation] = field(default_factory=list)

    def to_dict(self) -> dict:
        d = self.__dict__.copy()
        d["annotations"] = [a.to_dict() for a in self.annotations]
        return d


def filter_wcs_keys(headers: Dict[str, str]) -> Dict[str, str]:
    return {k: v for k, v in headers.items()
            if any(k.startswith(p) for p in WCS_KEY_WHITELIST_PREFIXES)}


def parse_annotations(payload: dict) -> List[FieldAnnotation]:
    """infra plate_solve.rs:57-87."""
    out = []
    for ann in payload.get("annotations", []):
        out.append(FieldAnnotation(
            kind=str(ann.get("type", "")),
            names=[str(n) for n in ann.get("names", [])],
            pixelx=float(ann.get("pixelx", 0.0)),
            pixely=float(ann.get("pixely", 0.0)),
            radius=(float(ann["radius"]) if "radius" in ann and
                    ann["radius"] is not None else None)))
    return out


def solve_offline_placeholder() -> SolveResult:
    raise SolveError(
        "Offline plate solving not available. Use the astrometry.net API "
        "with a configured key, or provide an image with WCS headers.")


def solve_astrometry_net(image_path: str,
                         config: SolveConfig = SolveConfig()) -> SolveResult:
    """Login → upload → poll → fetch WCS/annotations
    (infra plate_solve.rs:100+)."""
    if not config.api_key:
        raise SolveError("astrometry.net API key not configured")
    import urllib.error
    import urllib.parse
    import urllib.request

    def post(url, data, as_json=True):
        body = urllib.parse.urlencode(
            {"request-json": json.dumps(data)}).encode()
        req = urllib.request.Request(url, data=body)
        with urllib.request.urlopen(req, timeout=30) as resp:
            return json.loads(resp.read()) if as_json else resp.read()

    base = config.api_url.rstrip("/") + "/api"
    try:
        login = post(f"{base}/login", {"apikey": config.api_key})
        if login.get("status") != "success":
            raise SolveError(f"astrometry.net login failed: {login}")
        session = login["session"]

        upload_args = {"session": session, "publicly_visible": "n",
                       "allow_modifications": "d",
                       "allow_commercial_use": "d"}
        if config.ra_hint is not None and config.dec_hint is not None:
            upload_args.update({"center_ra": config.ra_hint,
                                "center_dec": config.dec_hint,
                                "radius": config.radius_hint or 10.0})
        if config.scale_low is not None:
            upload_args.update({"scale_units": "arcsecperpix",
                                "scale_type": "ul",
                                "scale_lower": config.scale_low,
                                "scale_upper": config.scale_high})

        boundary = "astroburstBoundary"
        with open(image_path, "rb") as f:
            file_data = f.read()
        parts = (
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="request-json"\r\n\r\n{json.dumps(upload_args)}\r\n'
            f"--{boundary}\r\nContent-Disposition: form-data; "
            f'name="file"; filename="upload.fits"\r\n'
            f"Content-Type: application/octet-stream\r\n\r\n"
        ).encode() + file_data + f"\r\n--{boundary}--\r\n".encode()
        req = urllib.request.Request(
            f"{base}/upload", data=parts,
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            up = json.loads(resp.read())
        if up.get("status") != "success":
            raise SolveError(f"astrometry.net upload failed: {up}")
        subid = up["subid"]

        deadline = time.monotonic() + config.timeout_secs
        job_id = None
        solved = False
        while time.monotonic() < deadline:
            sub = post(f"{base}/submissions/{subid}", {})
            jobs = [j for j in sub.get("jobs", []) if j]
            if jobs:
                job_id = jobs[0]
                status = post(f"{base}/jobs/{job_id}", {})
                if status.get("status") == "success":
                    solved = True
                    break
                if status.get("status") == "failure":
                    raise SolveError("astrometry.net solve failed")
            time.sleep(3.0)
        if not solved:
            raise SolveError("astrometry.net solve timed out")

        info = post(f"{base}/jobs/{job_id}/info", {})
        cal = info.get("calibration", {})
        ann_payload = post(f"{base}/jobs/{job_id}/annotations", {})
        return SolveResult(
            success=True,
            ra_center=float(cal.get("ra", 0.0)),
            dec_center=float(cal.get("dec", 0.0)),
            orientation=float(cal.get("orientation", 0.0)),
            pixel_scale=float(cal.get("pixscale", 0.0)),
            field_w_arcmin=float(cal.get("width_arcsec", 0.0)) / 60.0,
            field_h_arcmin=float(cal.get("height_arcsec", 0.0)) / 60.0,
            index_name=str(info.get("calibration_index", "")),
            stars_used=int(info.get("objects_in_field_count", 0) or 0),
            annotations=parse_annotations(ann_payload))
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise SolveError(f"astrometry.net unreachable: {e}")
