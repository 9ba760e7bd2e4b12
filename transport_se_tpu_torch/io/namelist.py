"""Fortran-namelist reader: drop-in acceptance of the reference's input.

The port's own copy of `transport_se_tpu/io/namelist.py` (numpy only), kept
bit-identical to it (tests/test_torch_host.py).

Equivalent of the reference `readnl` (reference: src/share/namelist_mod.F90:
143-340 reads &ctl_nl, &filter_nl, &vert_nl, &analysis_nl, &prof_inparm from
stdin into control_mod globals).  A user of the reference can point this at
the very same `*.nl` files (test/dcmip1-1/dcmip1-1.nl etc.) and get an
equivalent run: ctl_nl keys map onto Config, analysis_nl configures history
output, vert_nl selects the vertical coordinate files.

Keys present in the reference namelists but without behavioral effect in the
shipped DCMIP configs (filter_nl with filter_freq=0, smooth=0, nu/nu_s/nu_p=0,
energy_fixer=-1, accumfreq=-1, prof_inparm) are accepted and checked: if one
is set to a value that WOULD change behavior (e.g. filter_freq>0), we raise
instead of silently ignoring it.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

from ..config import Config

_GROUP_RE = re.compile(r"&(\w+)(.*?)(?:^|\n)\s*/", re.S | re.M)


def _parse_value(raw: str):
    raw = raw.strip()
    items = _split_items(raw)
    vals = [_parse_scalar(t) for t in items]
    return vals[0] if len(vals) == 1 else vals


def _split_items(raw: str):
    """Split a namelist RHS on commas not inside quotes."""
    items, cur, q = [], "", None
    for ch in raw:
        if q:
            cur += ch
            if ch == q:
                q = None
        elif ch in "'\"":
            q = ch
            cur += ch
        elif ch == ",":
            items.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip():
        items.append(cur)
    return [i.strip() for i in items if i.strip()]


def _parse_scalar(tok: str):
    if tok and tok[0] in "'\"":
        return tok[1:-1]
    low = tok.lower()
    if low in (".true.", "t", ".t."):
        return True
    if low in (".false.", "f", ".f."):
        return False
    num = low.replace("d", "e")  # Fortran double literals: 1.0D0
    try:
        if re.fullmatch(r"[+-]?\d+", num):
            return int(num)
        return float(num)
    except ValueError:
        return tok


def parse_namelist(text: str) -> dict:
    """-> {group: {key: value}}; '!' comments stripped, keys lowercased."""
    lines = []
    for line in text.splitlines():
        out, q = "", None
        for ch in line:
            if q:
                out += ch
                if ch == q:
                    q = None
            elif ch in "'\"":
                q = ch
                out += ch
            elif ch == "!":
                break
            else:
                out += ch
        lines.append(out)
    clean = "\n".join(lines)
    groups = {}
    for mm in _GROUP_RE.finditer(clean):
        name = mm.group(1).lower()
        body = mm.group(2)
        kv = {}
        for assign in re.finditer(
                r"(\w+)\s*=\s*(.*?)(?=(?:\n\s*\w+\s*=)|\Z)", body, re.S):
            kv[assign.group(1).lower()] = _parse_value(assign.group(2))
        groups[name] = kv
    return groups


@dataclasses.dataclass
class RunSettings:
    """Run-control settings beyond Config (driver/IO concerns)."""
    cfg: Config
    runtype: int = 0
    restartfreq: int = -1
    restartfile: str = "./R0001"
    output_dir: str = "./movies/"
    output_frequency: int = 0
    output_timeunits: int = 1
    output_varnames: tuple = ()
    vfile_mid: Optional[str] = None
    vfile_int: Optional[str] = None


# ctl_nl keys that are accepted but must hold their only-supported value
_REQUIRED = {
    "topology": "cube", "integration": "explicit", "tstep_type": 1,
    "smooth": 0.0, "nu": 0, "nu_s": 0, "nu_p": 0, "energy_fixer": -1,
    "hypervis_order": 2, "rotate_grid": 0,
}
# accepted and genuinely ignorable (parallel-runtime / legacy knobs)
_IGNORED = {"nthreads", "vert_num_threads", "partmethod", "npart",
            "accumfreq", "accumstart", "accumstop", "mesh_file",
            "hypervis_power", "hypervis_scaling", "initial_total_mass",
            "u_perturb", "columnpackage", "moisture", "use_semi_lagrange_transport"}


def config_from_namelist(text: str, nl_dir: str = ".") -> RunSettings:
    g = parse_namelist(text)
    ctl = dict(g.get("ctl_nl", {}))

    for key, required in _REQUIRED.items():
        if key in ctl:
            v = ctl.pop(key)
            if v != required and not (
                    isinstance(required, (int, float)) and float(v or 0)
                    == float(required)):
                raise NotImplementedError(
                    f"ctl_nl {key}={v!r}: only {required!r} supported "
                    "(the shipped transport_se behavior)")

    fil = g.get("filter_nl", {})
    if fil.get("filter_freq", 0) or fil.get("filter_freq_advection", 0):
        raise NotImplementedError(
            "filter_freq != 0: spectral filters are legacy-off in all "
            "DCMIP configs (SURVEY §2 filter_mod)")

    def pop(key, default):
        return ctl.pop(key, default)

    kw = dict(
        ne=int(pop("ne", 0)),
        qsize=int(pop("qsize", 4)),
        ndays=float(pop("ndays", 0)),
        nmax=int(pop("nmax", 0)),
        statefreq=int(pop("statefreq", 20)),
        tstep=float(pop("tstep", 0)),
        qsplit=int(pop("qsplit", 1)),
        rsplit=int(pop("rsplit", 3)),
        nu_q=float(pop("nu_q", 0)),
        limiter_option=int(pop("limiter_option", 8)),
        hypervis_subcycle_q=int(pop("hypervis_subcycle_q",
                                    pop("hypervis_subcycle", 1))),
        test_case=str(pop("test_case", "dcmip1-1")),
        prescribed_wind=bool(pop("prescribed_wind", 1)),
        vert_remap_q_alg=int(pop("vert_remap_q_alg", 0)),
        # extension key (no reference analog): select the unbounded PPM
        # interface search instead of aborting past +-2 cells of
        # deformation (config.py ppm_search)
        ppm_search=str(pop("ppm_search", "fast")).strip("'\""),
        disable_diagnostics=bool(pop("disable_diagnostics", False)),
    )
    runtype = int(pop("runtype", 0))
    restartfreq = int(pop("restartfreq", -1))
    restartfile = str(pop("restartfile", "./R0001"))
    leftover = {k: v for k, v in ctl.items() if k not in _IGNORED}
    if leftover:
        raise NotImplementedError(f"unrecognized ctl_nl keys: {leftover}")

    # vertical coordinate: use the named files when they exist relative to
    # the namelist's directory; otherwise fall back on the shipped acme-72
    # data or the analytic dcmip generator (vert_nl, hvcoord_init analog)
    vert = g.get("vert_nl", {})
    vfile_mid = vert.get("vfile_mid")
    vfile_int = vert.get("vfile_int")
    vcoord = "acme72"
    if vfile_mid and vfile_int:
        mid = os.path.join(nl_dir, vfile_mid)
        intp = os.path.join(nl_dir, vfile_int)
        if os.path.exists(mid) and os.path.exists(intp):
            vcoord = f"files:{mid}:{intp}"
        elif "acme-72" in vfile_mid:
            vcoord = "acme72"
        else:
            m2 = re.search(r"(\d+)m", os.path.basename(vfile_mid))
            vcoord = f"dcmip{m2.group(1)}" if m2 else "acme72"
    kw["vcoord"] = vcoord
    if vcoord.startswith("files:"):
        from ..grid.vcoord import hvcoord_from_files
        kw["nlev"] = hvcoord_from_files(*vcoord.split(":")[1:]).nlev
    elif vcoord.startswith("dcmip"):
        kw["nlev"] = int(vcoord[len("dcmip"):])
    else:
        kw["nlev"] = 72

    ana = g.get("analysis_nl", {})
    raw_names = ana.get("output_varnames1", ())
    if isinstance(raw_names, str):
        raw_names = (raw_names,)
    return RunSettings(
        cfg=Config(**kw),
        runtype=runtype,
        restartfreq=restartfreq,
        restartfile=restartfile,
        output_dir=str(ana.get("output_dir", "./movies/")),
        output_frequency=int(ana.get("output_frequency", 0)),
        output_timeunits=int(ana.get("output_timeunits", 1)),
        output_varnames=tuple(raw_names),
    )
