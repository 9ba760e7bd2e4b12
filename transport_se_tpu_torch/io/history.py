"""NetCDF history ("movie") output on unique GLL points.

The port's own copy of `transport_se_tpu/io/history.py` (numpy only), kept
bit-identical to it (tests/test_torch_host.py).

Equivalent of the reference history stack (reference:
src/prim_movie_mod.F90:69 `prim_movie_init`, :295 `prim_movie_output`;
variable registry src/common_movie_mod.F90:15-52; PIO/netcdf wrappers
src/netcdf_io_mod.F90).  The reference gathers each element's *owned* GLL
points (dof_mod.F90:125 `UniquePoints`) into an `ncol` dimension so shared
points are written exactly once; we do the same via the grid's precomputed
unique-point owner table (grid.uniq_src / grid.col_of_gid).

TPU-first design: output is a host-side concern — fields are fetched from
device once per output interval (one device->host transfer of the already
final Q/ps arrays), then scattered to ncol order with one numpy gather.  No
io-processor subsetting / box rearranging (PIO's job on 2015 clusters) is
needed.  Files are NetCDF3 64-bit-offset classic written with scipy (no
external IO library), readable by the reference's own NCL/ncdump tooling.

Variable names, dims, and units match the reference registry so a user's
post-processing scripts (e.g. test/dcmip1-1/dcmip1-1_error_norm_ng.ncl,
which reads Q(time,lev,ncol), lat, lon) work unchanged:
  dims:  ncol, lev, ilev, time (unlimited)
  vars:  lat(ncol) degrees_north, lon(ncol) degrees_east, lev, ilev,
         hyam, hybm, hyai, hybi, time(time) days, ps(time,ncol),
         area(ncol), Q..Q<n>(time,lev,ncol), u/v(time,lev,ncol),
         geo(time,lev,ncol), faceno(ncol)
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from scipy.io import netcdf_file

from ..constants import DD_PI, G, P0, SCALE_HEIGHT

RAD2DEG = 180.0 / DD_PI

# default output set (analysis_nl output_varnames1 of the shipped DCMIP
# namelists is 'Q','Q3','geo' / 'Q2','geo'; we default to all tracers + ps)
DEFAULT_VARS = ("ps", "Q", "u", "v", "geo")


def unique_gather(grid, field_flat_points: np.ndarray) -> np.ndarray:
    """Gather a [..., E*np*np] point field to [..., ncol] unique columns."""
    return field_flat_points[..., grid.uniq_src]


class HistoryWriter:
    """Writes one history stream (reference output_stream analog).

    Parameters
    ----------
    path : output file (output_dir + movie name in the reference)
    varnames : which time-varying vars to write; tracer request 'Q' expands
        to Q..Q<qsize> ('Q','Q2',... like common_movie_mod.F90:39-42).
    output_frequency / output_timeunits : reference analysis_nl semantics
        (timeunits 1=days, 2=hours, 0=timesteps; common_io_mod.F90).
    """

    def __init__(self, path: str, model, varnames: Sequence[str] = DEFAULT_VARS,
                 output_frequency: int = 1, output_timeunits: int = 1):
        self.path = path
        self.varnames = tuple(varnames)
        self.output_frequency = output_frequency
        self.output_timeunits = output_timeunits
        self._itime = 0
        m = model
        grid = m.grid
        cfg = m.cfg
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        f = netcdf_file(path, "w", version=2)  # 64-bit offset
        self._f = f

        ncol = grid.ngid
        f.createDimension("time", None)  # unlimited must be defined first
        f.createDimension("ncol", ncol)
        f.createDimension("lev", cfg.nlev)
        f.createDimension("ilev", cfg.nlev + 1)

        lat = unique_gather(grid, grid.lat.reshape(-1)) * RAD2DEG
        lon = unique_gather(grid, grid.lon.reshape(-1)) * RAD2DEG

        def static(name, dims, data, units=None, long_name=None):
            v = f.createVariable(name, "d", dims)
            v[:] = np.asarray(data, dtype=np.float64)
            if units:
                v.units = units
            if long_name:
                v.long_name = long_name
            return v

        static("lat", ("ncol",), lat, "degrees_north", "column latitude")
        static("lon", ("ncol",), lon, "degrees_east", "column longitude")
        etam = np.asarray(m.hv.etam)
        etai = np.asarray(m.hv.etai)
        static("lev", ("lev",), 1000.0 * etam, "hybrid level at midpoints")
        static("ilev", ("ilev",), 1000.0 * etai,
               "hybrid level at interfaces")
        static("hyam", ("lev",), m.hv.hyam)
        static("hybm", ("lev",), m.hv.hybm)
        static("hyai", ("ilev",), m.hv.hyai)
        static("hybi", ("ilev",), m.hv.hybi)
        # DSS-assembled area weights (prim_movie_mod writes elem mp*metdet
        # summed over coincident points = 1/rspheremp)
        area = unique_gather(grid, (1.0 / grid.rspheremp).reshape(-1))
        static("area", ("ncol",), area, "radians^2", "area weights")
        # geos = surface geopotential phis (prim_movie_mod.F90:372-380);
        # zero in the DCMIP tests (no orography, dcmip_wrapper sets phis=0)
        static("geos", ("ncol",), np.zeros_like(area), "m^2/s^2",
               "surface geopotential")
        # hypervis = variable-viscosity length-scale field
        # (prim_movie_mod.F90:357-368); constant-coefficient configs
        # (every shipped namelist: hypervis_power=0) carry 1.0
        static("hypervis", ("ncol",), np.ones_like(area), "",
               "variable hyperviscosity scale")
        static("faceno", ("ncol",),
               unique_gather(grid, np.broadcast_to(
                   grid.face[:, None, None].astype(np.float64),
                   grid.lat.shape).reshape(-1)))

        self._time = f.createVariable("time", "d", ("time",))
        self._time.units = "days"
        self._time.long_name = "Model elapsed time"

        self._vars = {}
        units = {"geo": "m^2/s^2", "u": "meters/second",
                 "v": "meters/second", "T": "degrees kelvin",
                 "zeta": "1/s", "div": "1/s", "omega": "Pa/s",
                 "ke": "m^2/s^2", "Th": "degrees kelvin"}
        for name in self._expand_tracers(cfg.qsize):
            if name in ("ps",):
                v = f.createVariable(name, "d", ("time", "ncol"))
                v.units = "pascals"
                v.long_name = "surface pressure"
            else:
                v = f.createVariable(name, "d", ("time", "lev", "ncol"))
                if name in units:
                    v.units = units[name]
            self._vars[name] = v

        # geopotential is time-independent under prescribed winds:
        # phi = g*z = g*H*log(1/etam) (dcmip_wrapper_mod.F90:196)
        self._geo_col = G * SCALE_HEIGHT * np.log(1.0 / etam)

    def _expand_tracers(self, qsize: int):
        out = []
        for name in self.varnames:
            if name == "Q":
                out.extend(["Q"] + [f"Q{i}" for i in range(2, qsize + 1)])
            else:
                out.append(name)
        return out

    def due(self, nstep: int, cfg) -> bool:
        """Modular output-step test at subcycle granularity.

        Equivalent to the reference's nextoutputstep bookkeeping
        (common_movie_mod.F90:275-293) whenever the output interval is
        >= rsplit steps (every shipped namelist); intervals shorter than
        one subcycle collapse to one output per subcycle here.
        """
        if self.output_frequency <= 0:
            return False
        if self.output_timeunits == 1:      # days
            interval = int(round(self.output_frequency * 86400.0 / cfg.tstep))
        elif self.output_timeunits == 2:    # hours
            interval = int(round(self.output_frequency * 3600.0 / cfg.tstep))
        else:                               # timesteps
            interval = self.output_frequency
        interval = max(interval, 1)
        return nstep % interval < cfg.rsplit and nstep >= interval

    # time-varying level fields supplied via `extras` (diagnostics.py
    # `flow_fields`): u, v, zeta, div, omega, T
    EXTRA_FIELDS = ("u", "v", "zeta", "div", "omega", "T", "ke", "Th")

    def needs_extras(self) -> bool:
        return any(n in self._vars for n in self.EXTRA_FIELDS)

    def write(self, model, nstep: int, Q: np.ndarray, ps: np.ndarray,
              extras: Optional[dict] = None):
        """Append one time record.

        Q:  [E, qsize, nlev, np, np] mixing ratios (host numpy)
        ps: [E, np, np]
        extras: optional {name: [E, nlev, np, np]} for EXTRA_FIELDS
        """
        m = model
        grid = m.grid
        i = self._itime
        self._time[i] = nstep * m.cfg.tstep / 86400.0

        def put_lev(v, field):
            w = np.moveaxis(np.asarray(field), 1, 0)
            v[i] = unique_gather(grid, w.reshape(m.cfg.nlev, -1))

        for name, v in self._vars.items():
            if name == "ps":
                v[i] = unique_gather(grid, np.asarray(ps).reshape(-1))
            elif name == "geo":
                v[i] = np.broadcast_to(
                    self._geo_col[:, None], (m.cfg.nlev, grid.ngid))
            elif name in self.EXTRA_FIELDS:
                if extras is not None and name in extras:
                    put_lev(v, extras[name][:, :m.cfg.nlev])
            else:  # tracer Q / Q<n>
                qi = 0 if name == "Q" else int(name[1:]) - 1
                put_lev(v, np.asarray(Q)[:, qi])
        self._itime += 1
        self._f.flush()

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
