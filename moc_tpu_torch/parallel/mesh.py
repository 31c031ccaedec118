"""Meshes over the ranks of a ``torch.distributed`` run (PyTorch port of
``moc_tpu/parallel/mesh.py``).

The axis names are the JAX package's: ``data`` (batch), ``seq`` (sequence),
``tensor`` (heads and FFN hidden width), ``expert`` (MoE experts) and
``pipe`` (pipeline stages). A mesh lays the ranks out as an array of
those axes; :meth:`Mesh.axis` gives the :class:`Axis` a collective runs
over: the ranks that share every other coordinate with this one, in the
order of the named axes (row-major when several are named). The process
groups are made when the mesh is built, one per group of every set of the
mesh's axes wider than one rank, since every rank must take part in making
each group; building a mesh is therefore a collective call.

Code that names an axis by string (``EncoderConfig.ring_axis`` and the
like, as JAX code names axes inside ``shard_map``) looks it up in the mesh
that is active: ``with mesh:`` makes it so, as a JAX mesh context does.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from moc_tpu_torch.parallel import runtime

AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_TENSOR = "tensor"
AXIS_EXPERT = "expert"
AXIS_PIPE = "pipe"  # innermost, as in JAX: neighbouring stages are neighbouring ranks

DEFAULT_AXES = (AXIS_DATA, AXIS_SEQ, AXIS_TENSOR, AXIS_EXPERT, AXIS_PIPE)

_active: list["Mesh"] = []


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One or more mesh axes as a collective sees them: this rank's
    ``index`` among the ``size`` ranks of its group, their global ``ranks``
    in axis order, and the process ``group`` (None when ``size`` is 1)."""

    names: tuple[str, ...]
    size: int
    index: int
    ranks: tuple[int, ...]
    group: object | None


class Mesh:
    """``devices``: an array of global ranks, one dimension per axis name."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d rank array for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        me = np.argwhere(self.devices == runtime.process_index())
        self.coords = tuple(int(c) for c in me[0]) if len(me) else None
        self._axes: dict[tuple[str, ...], Axis] = {}
        self._make_groups()

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"

    def _rows(self, names: tuple[str, ...]) -> np.ndarray:
        """``[groups, size]``: the ranks of every group along ``names``."""
        dims = [self.axis_names.index(n) for n in names]
        rest = [d for d in range(len(self.axis_names)) if d not in dims]
        moved = np.transpose(self.devices, rest + dims)
        return moved.reshape(-1, int(np.prod([self.devices.shape[d] for d in dims])))

    def _make_groups(self) -> None:
        wide = tuple(a for a in self.axis_names if self.shape[a] > 1)
        distributed = runtime.process_count() > 1
        for r in range(1, len(wide) + 1):
            for names in itertools.combinations(wide, r):
                rows = self._rows(names)
                mine = None
                for row in rows:
                    ranks = tuple(int(x) for x in row)
                    group = (dist.new_group(list(ranks), timeout=runtime.timeout())
                             if distributed else None)
                    if runtime.process_index() in ranks:
                        mine = Axis(names, len(ranks), ranks.index(runtime.process_index()),
                                    ranks, group)
                if mine is not None:
                    self._axes[names] = mine

    def axis(self, names: str | Sequence[str]) -> Axis:
        """The :class:`Axis` of this rank along ``names`` (one axis name or
        several, in mesh order); axes the mesh lacks or holds at size 1 drop
        out, and an axis of no width is a group of one."""
        if isinstance(names, str):
            names = (names,)
        unknown = [n for n in names if n not in DEFAULT_AXES]
        if unknown:
            raise ValueError(f"unknown mesh axes {unknown}; valid: {list(DEFAULT_AXES)}")
        if self.coords is None:
            raise ValueError(f"rank {runtime.process_index()} is not in {self!r}")
        wide = tuple(a for a in self.axis_names if a in names and self.shape[a] > 1)
        if not wide:
            me = runtime.process_index()
            return Axis(tuple(names), 1, 0, (me,), None)
        return self._axes[wide]

    def index(self, name: str) -> int:
        """This rank's coordinate along one axis (0 for an axis it lacks)."""
        return self.coords[self.axis_names.index(name)] if name in self.shape else 0

    def __enter__(self) -> "Mesh":
        _active.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _active.remove(self)


def current_mesh() -> Mesh:
    """The mesh of the innermost ``with mesh:``."""
    if not _active:
        raise RuntimeError("no active mesh: name mesh axes inside `with mesh:`")
    return _active[-1]


def resolve_axis(axis: str | Sequence[str] | Axis) -> Axis:
    """An :class:`Axis` as given, or looked up by name in the active mesh."""
    return axis if isinstance(axis, Axis) else current_mesh().axis(axis)


def make_mesh(axis_sizes: Mapping[str, int] | None = None,
              devices: Sequence[int] | None = None) -> Mesh:
    """A mesh over ``devices`` (global ranks; default all of them) with the
    given axis sizes: unnamed axes are absent, and one axis of ``-1``
    absorbs the remaining ranks. ``make_mesh({"data": -1, "expert": 2})``
    over 8 ranks gives data=4, expert=2."""
    if devices is None:
        devices = list(range(runtime.process_count()))
    n = len(devices)
    sizes = dict(axis_sizes or {AXIS_DATA: n})
    unknown = sorted(set(sizes) - set(DEFAULT_AXES))
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; valid: {list(DEFAULT_AXES)}")
    names = [a for a in DEFAULT_AXES if a in sizes] or [AXIS_DATA]
    fill = [a for a in names if sizes.get(a, 1) == -1]
    fixed = int(np.prod([s for s in sizes.values() if s != -1]))
    if fill:
        if len(fill) != 1:
            raise ValueError(f"only one axis may be -1, got {fill}")
        if n % fixed:
            raise ValueError(f"mesh {sizes} does not divide {n} ranks")
        sizes[fill[0]] = n // fixed
        fixed = n
    if fixed > n:
        raise ValueError(f"mesh {sizes} needs {fixed} ranks, have {n}")
    shape = tuple(sizes[a] for a in names)
    return Mesh(np.asarray(devices[:fixed]).reshape(shape), names)


def make_hybrid_mesh(axis_sizes: Mapping[str, int], dcn_axes: Sequence[str] = (AXIS_DATA,),
                     devices: Sequence[int] | None = None,
                     num_slices: int | None = None) -> Mesh:
    """A mesh whose ``dcn_axes`` vary across slices (contiguous equal groups
    of ``devices``: hosts, or islands of a fast interconnect) and whose other
    axes vary within one, so their collectives never leave a slice. The
    ``dcn_axes`` multiply to the slice count and the others to the ranks
    per slice; one of either group may be ``-1``."""
    if devices is None:
        devices = list(range(runtime.process_count()))
    unknown = sorted(set(axis_sizes) - set(DEFAULT_AXES))
    if unknown:
        raise ValueError(f"unknown mesh axes {unknown}; valid: {list(DEFAULT_AXES)}")
    bad_dcn = sorted(set(dcn_axes) - set(axis_sizes))
    if bad_dcn:
        raise ValueError(f"dcn_axes {bad_dcn} missing from axis_sizes")
    k = num_slices or 1
    if len(devices) % k:
        raise ValueError(f"{len(devices)} devices do not split into {k} equal slices")
    per_slice = len(devices) // k

    def resolve(names, budget: int, kind: str) -> dict[str, int]:
        sizes = {a: axis_sizes[a] for a in names}
        fill = [a for a, s in sizes.items() if s == -1]
        fixed = int(np.prod([s for s in sizes.values() if s != -1]))
        if len(fill) > 1:
            raise ValueError(f"only one {kind} axis may be -1, got {fill}")
        if fill:
            if budget % fixed:
                raise ValueError(f"{kind} axes {sizes} do not divide {budget} devices")
            sizes[fill[0]] = budget // fixed
            fixed = budget
        if fixed != budget:
            raise ValueError(
                f"{kind} axes {sizes} multiply to {fixed}, need {budget} "
                f"({'slice count' if kind == 'dcn' else 'devices per slice'})")
        return sizes

    dcn_names = [a for a in DEFAULT_AXES if a in dcn_axes]
    ici_names = [a for a in DEFAULT_AXES if a in axis_sizes and a not in dcn_axes]
    dcn_sizes = resolve(dcn_names, k, "dcn")
    ici_sizes = resolve(ici_names, per_slice, "ici") if ici_names else {}
    shape = tuple(dcn_sizes[a] for a in dcn_names) + tuple(ici_sizes[a] for a in ici_names)
    return Mesh(np.asarray(devices).reshape(shape), dcn_names + ici_names)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout over a mesh: per dimension an axis name (or a tuple of
    them), or None for a replicated dimension."""

    mesh: Mesh
    spec: tuple


def shard_spec(mesh: Mesh, *axes: str | None) -> NamedSharding:
    """The layout with one axis name (or None) per dimension, axes the mesh
    lacks dropped to None."""
    return NamedSharding(mesh, tuple(a if (a is None or a in mesh.axis_names) else None
                                     for a in axes))


def spec_of(spec) -> tuple:
    return spec.spec if isinstance(spec, NamedSharding) else tuple(spec)


def local_block(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` laid out as ``spec``."""
    for dim, axes in enumerate(spec_of(spec)):
        if axes is None:
            continue
        ax = mesh.axis(axes)
        if x.shape[dim] % ax.size:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split over "
                             f"{ax.size} ranks of {ax.names}")
        n = x.shape[dim] // ax.size
        x = x.narrow(dim, ax.index * n, n)
    return x


def local_slice(axis_name: str) -> int:
    """This rank's index along a mesh axis of the active mesh."""
    return current_mesh().axis(axis_name).index
