"""Hybrid vertical coordinate (p = hya*p0 + hyb*ps).

The port's own copy of `transport_se_tpu/grid/vcoord.py` (numpy only), kept
bit-identical to it (tests/test_torch_host.py).

Equivalent of reference src/share/hybvcoord_mod.F90 (`hvcoord_init`,
`set_layer_locations`).  Ships the ACME 72-level coefficient data used by all
verification configs (reference test/vcoord/acme-72{m,i}.ascii) and can also
generate the evenly-spaced-in-z DCMIP coefficient sets (reference
dcmip_wrapper_mod.F90:316 `write_level_files`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ..constants import P0, SCALE_HEIGHT

_DATA_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "data")


@dataclasses.dataclass(frozen=True)
class HVCoord:
    ps0: float
    hyai: np.ndarray   # [nlev+1]
    hybi: np.ndarray   # [nlev+1]
    hyam: np.ndarray   # [nlev]
    hybm: np.ndarray   # [nlev]

    @property
    def nlev(self) -> int:
        return self.hyam.size

    @property
    def etam(self) -> np.ndarray:
        return self.hyam + self.hybm

    @property
    def etai(self) -> np.ndarray:
        return self.hyai + self.hybi

    @property
    def dp0(self) -> np.ndarray:
        """Reference layer thickness at ps = ps0.

        Matches the hyperviscosity dp0 in euler_step
        (prim_advection_mod.F90:817-819): both A and B differences scale ps0.
        """
        return ((self.hyai[1:] - self.hyai[:-1]) * self.ps0
                + (self.hybi[1:] - self.hybi[:-1]) * self.ps0)


def _read_ascii_pair(path: str):
    """Read one of the reference's ascii coefficient files: two blocks of
    'count ! name' followed by count values."""
    vals = []
    with open(path) as f:
        tokens = f.read().split()
    i = 0
    blocks = []
    while i < len(tokens):
        # count token, optionally followed by '!' 'name'
        n = int(tokens[i]); i += 1
        while i < len(tokens) and not _is_float(tokens[i]):
            i += 1
        block = [float(tokens[i + k]) for k in range(n)]
        i += n
        blocks.append(np.asarray(block))
    return blocks


def _is_float(tok: str) -> bool:
    try:
        float(tok)
        return True
    except ValueError:
        return False


def hvcoord_from_files(mid_path: str, int_path: str) -> HVCoord:
    hyai, hybi = _read_ascii_pair(int_path)
    hyam, hybm = _read_ascii_pair(mid_path)
    return HVCoord(ps0=P0, hyai=hyai, hybi=hybi, hyam=hyam, hybm=hybm)


def hvcoord_acme72() -> HVCoord:
    """The shipped ACME 72-level coordinate (the graded config)."""
    return hvcoord_from_files(
        os.path.join(_DATA_DIR, "acme-72m.ascii"),
        os.path.join(_DATA_DIR, "acme-72i.ascii"))


def hvcoord_dcmip(nlev: int, z_top: float = 12000.0, c: float = 2.0) -> HVCoord:
    """Evenly-spaced-in-z hybrid levels for a T=300K isothermal atmosphere.

    Port of the generator formula in dcmip_wrapper_mod.F90:316-358.
    """
    k = np.arange(nlev + 1)
    zi = z_top - z_top * k / nlev
    etai = np.exp(-zi / SCALE_HEIGHT)
    Bi = ((etai - etai[0]) / (1.0 - etai[0])) ** c
    Ai = etai - Bi
    Bm = 0.5 * (Bi[1:] + Bi[:-1])
    Am = 0.5 * (Ai[1:] + Ai[:-1])
    return HVCoord(ps0=P0, hyai=Ai, hybi=Bi, hyam=Am, hybm=Bm)
