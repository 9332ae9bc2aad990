"""Device meshes from a one-line spec string.

Port of ``scalerl_tpu/parallel/mesh.py``: ``"dp=4,fsdp=2"``-style specs
parsed into a mesh over the seven named axes of :data:`AXIS_NAMES`, every
axis the spec leaves out at size 1.

The JAX package drives several devices from one process; PyTorch runs one
process a device.  So a :class:`Mesh` spans the ranks of the default
process group (gloo on the CPU, nccl on the card), ``n_devices`` defaults
to its world size, and its ``device_mesh`` is a
``torch.distributed.device_mesh.DeviceMesh`` whose dims carry the axis
names.  A one-device mesh needs no group: it has no ``device_mesh``, and
every collective over it is the identity.  A mesh of more devices with no
initialised group raises.

:func:`with_own_groups` gives a mesh over the same ranks whose axes have
process groups of their own: a second thread (the inference server's
flush) issues its collectives there, so they never interleave with the
learner thread's on the mesh's own groups.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch.distributed as dist

# Fixed axis order (the JAX package's): dp outermost, then pipeline stages,
# the param-sharding axis, tensor / sequence / expert, and the model axis of
# the dp x mp learner innermost.  ``mp`` is driven by the logical rule table
# (parallel/logical.py), ``tp`` by the heuristic rule (parallel/sharding.py).
AXIS_NAMES: Tuple[str, ...] = ("dp", "pp", "fsdp", "tp", "sp", "ep", "mp")


@dataclass(frozen=True)
class MeshSpec:
    """Parsed mesh shape, e.g. ``MeshSpec.parse("dp=4,tp=2")``."""

    sizes: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def parse(cls, spec: Optional[str]) -> "MeshSpec":
        sizes: Dict[str, int] = {}
        if spec:
            for part in spec.replace(" ", "").split(","):
                if not part:
                    continue
                name, _, val = part.partition("=")
                if name not in AXIS_NAMES:
                    raise ValueError(f"unknown mesh axis {name!r}; valid axes: {AXIS_NAMES}")
                sizes[name] = int(val)
        return cls(sizes=sizes)

    def size(self, axis: str) -> int:
        return self.sizes.get(axis, 1)

    @property
    def total(self) -> int:
        n = 1
        for v in self.sizes.values():
            n *= v
        return n

    def shape(self) -> Tuple[int, ...]:
        return tuple(self.size(a) for a in AXIS_NAMES)


@dataclass(frozen=True, eq=False)
class Mesh:
    """A mesh over the ranks of the default process group.

    ``shape`` maps every axis of :data:`AXIS_NAMES` to its extent (the JAX
    ``Mesh.shape``); ``device_mesh`` is the named ``DeviceMesh``, None for a
    one-device mesh built with no process group; ``groups``, where set, the
    process group of each axis of more than one rank in place of the
    device mesh's (:func:`with_own_groups`)."""

    shape: Dict[str, int]
    device_type: str
    device_mesh: Optional[object] = None
    groups: Optional[Dict[str, object]] = None

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def extent(self, axes: Tuple[str, ...]) -> int:
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        if self.device_mesh is None:
            return 0
        return self.device_mesh.get_coordinate()[AXIS_NAMES.index(axis)]

    def group(self, axis: str):
        """The process group along ``axis`` (None when it has one rank)."""
        if self.device_mesh is None or self.shape[axis] == 1:
            return None
        if self.groups is not None:
            return self.groups[axis]
        return self.device_mesh.get_group(axis)


def with_own_groups(mesh: Mesh, timeout=None) -> Mesh:
    """``mesh`` over the same ranks and coordinates, with a new process
    group for each line of each axis of more than one rank (``timeout``,
    a ``datetime.timedelta``, bounds each collective's wait on them).
    ``new_group`` is collective over the world, so every rank calls this at
    the same point, and builds every line's group in the same order; a mesh
    with no process group comes back as it is."""
    if mesh.device_mesh is None:
        return mesh
    ranks = mesh.device_mesh.mesh
    me = dist.get_rank()
    groups: Dict[str, object] = {}
    for i, axis in enumerate(AXIS_NAMES):
        if mesh.shape[axis] == 1:
            continue
        for line in ranks.movedim(i, -1).reshape(-1, mesh.shape[axis]).tolist():
            group = dist.new_group(line, timeout=timeout)
            if me in line:
                groups[axis] = group
    return Mesh(shape=dict(mesh.shape), device_type=mesh.device_type,
                device_mesh=mesh.device_mesh, groups=groups)


def _default_device_type() -> str:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


def make_mesh(spec: Optional[str] = None, n_devices: Optional[int] = None,
              device_type: Optional[str] = None) -> Mesh:
    """A mesh over ``n_devices`` ranks (default: the world size of the
    initialised process group, else 1) from a spec string.

    With no spec every device goes on ``dp``, the pure data-parallel
    layout.  ``device_type`` defaults to ``"cuda"`` under nccl and
    ``"cpu"`` otherwise."""
    parsed = MeshSpec.parse(spec)
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    sizes = dict(parsed.sizes)
    named_total = parsed.total
    if spec is None or not sizes:
        sizes = {"dp": n_devices}
        named_total = n_devices
    if not dist.is_initialized() and max(named_total, n_devices) > 1:
        raise ValueError(
            f"a mesh of {max(named_total, n_devices)} devices needs a process group of as "
            "many ranks: call torch.distributed.init_process_group first (or start the "
            "ranks with torchrun)")
    if named_total != n_devices:
        raise ValueError(f"mesh spec {spec!r} wants {named_total} devices, got {n_devices}")
    shape = {a: sizes.get(a, 1) for a in AXIS_NAMES}
    device_type = device_type or _default_device_type()
    if not dist.is_initialized():
        return Mesh(shape=shape, device_type=device_type)
    from torch.distributed.device_mesh import init_device_mesh

    device_mesh = init_device_mesh(
        device_type, tuple(shape[a] for a in AXIS_NAMES), mesh_dim_names=AXIS_NAMES)
    return Mesh(shape=shape, device_type=device_type, device_mesh=device_mesh)


def resolve_mesh(mesh_or_spec) -> Mesh:
    """A :class:`Mesh` passes through; a spec string (or None) builds one:
    the one resolution rule of every ``enable_mesh``."""
    if isinstance(mesh_or_spec, Mesh):
        return mesh_or_spec
    return make_mesh(mesh_or_spec)


def mesh_spec_from_args(args, n_devices: Optional[int] = None) -> Optional[str]:
    """The mesh spec an ``RLArguments`` asks for, or None.

    An explicit ``mesh_shape`` wins.  Otherwise ``dp_size``/``mp_size``
    compose ``"dp=D,mp=M"``: ``mp_size > 1`` (or ``dp_size > 0``) opts in,
    and ``dp_size == 0`` takes every remaining device
    (``n_devices // mp_size``, ``n_devices`` defaulting to the world size)."""
    spec = getattr(args, "mesh_shape", None)
    if spec:
        return spec
    mp = int(getattr(args, "mp_size", 1) or 1)
    dp = int(getattr(args, "dp_size", 0) or 0)
    if mp <= 1 and dp <= 0:
        return None
    if dp <= 0:
        if n_devices is None:
            n_devices = dist.get_world_size() if dist.is_initialized() else 1
        if n_devices % mp != 0:
            raise ValueError(
                f"mp_size={mp} does not divide the {n_devices} visible devices; set "
                "dp_size explicitly or adjust mp_size")
        dp = n_devices // mp
    if mp <= 1:
        return f"dp={dp}"
    return f"dp={dp},mp={mp}"

