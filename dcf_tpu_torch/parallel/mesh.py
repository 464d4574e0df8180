"""Device meshes and the sharded walk.

Counterpart of ``dcf_tpu/parallel/mesh.py``.  A ``Mesh`` is a 2D
(keys x points) grid of ``torch.device``s, as ``jax.sharding.Mesh`` is of
JAX devices.  PyTorch has no ``shard_map``: a sharded class here holds one
single-device backend instance for each (key shard, device) of its mesh,
gives each mesh position its key slice and its point slice, launches
every position's kernels (each wrapper pins its position's device and
that device's current stream, ``ops._launch.launch_checked``) before it
synchronises any of them, and assembles the blocks.  ``dcf_tpu``'s walks
are pure maps with no collective inside, so this per-position map is the
whole of what ``shard_map`` did for them.

- ``make_mesh`` factorizes the cards of this host (``device="cuda"``,
  the default) or ``n_devices`` CPU positions (``device="cpu"``; the
  count defaults to ``DCF_CPU_DEVICES``, else 1), the stand-ins for
  ``dcf_tpu``'s virtual XLA CPU devices, on which the kernels' plain
  versions run.  It never repeats a card.  A ``Mesh`` built directly
  from a device array may repeat one: a one-card host runs a 2 x 2 mesh
  as four positions on ``cuda:0``.
- ``make_pod_mesh`` spans every process of a ``torch.distributed`` group
  (``parallel._compat.distributed_initialize``): one position a process,
  shape (1, processes) by default.
- ``ShardedWalkBackend`` is the one counterpart of ``dcf_tpu``'s
  ``ShardedJaxBackend``, ``ShardedBitslicedBackend`` (this file) and
  ``ShardedPallasBackend`` (``pallas_sharded.py``): three routes there to
  the from-root walk, kernels B1 (lam = 16) and E1 (lam = 32) here.
- ``ShardedTensor`` is what a sharded ``eval_staged`` returns: the
  per-position blocks, still on their devices.
"""

from __future__ import annotations

import os
import warnings
from typing import Sequence

import numpy as np
import torch

from dcf_tpu_torch.backends._common import points_mismatch_count
from dcf_tpu_torch.backends.walk_backend import POINT_TILE, WalkBackend
from dcf_tpu_torch.errors import (
    BackendUnavailableError,
    ShapeError,
    StaleStateError,
)
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.walk_eval import group_add_plain
from dcf_tpu_torch.parallel import _compat
from dcf_tpu_torch.spec import (
    ReferenceContractWarning,
    hirose_used_cipher_indices,
)
from dcf_tpu_torch.testing.faults import fire
from dcf_tpu_torch.utils.groups import group_width

__all__ = ["Mesh", "mesh_shape", "make_mesh", "make_pod_mesh",
           "ShardedTensor", "ShardedWalkBackend", "CPU_DEVICES_ENV",
           "key_slice"]

#: The environment variable that sets how many CPU positions a CPU mesh
#: has (``dcf_tpu``'s ``xla_force_host_platform_device_count``).
CPU_DEVICES_ENV = "DCF_CPU_DEVICES"


class Mesh:
    """A 2D grid of ``torch.device``s with named axes (``keys``,
    ``points``).  ``shape`` is a dict, as ``jax.sharding.Mesh`` gives
    it; ``devices`` the numpy object array of devices."""

    def __init__(self, devices, axis_names: tuple[str, str] = ("keys",
                                                              "points")):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2 or 0 in grid.shape:
            raise ShapeError(f"a mesh is a non-empty 2D device grid, got "
                             f"shape {grid.shape}")
        if len(axis_names) != 2:
            raise ShapeError(f"a mesh has two axes, got {axis_names}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            d = torch.device(d)
            if d.type == "cuda" and d.index is None \
                    and torch.cuda.is_available():
                d = torch.device("cuda", torch.cuda.current_device())
            self.devices[idx] = d
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def _cpu_count(n_devices, shape) -> int:
    env = os.environ.get(CPU_DEVICES_ENV)
    if env:
        return int(env)
    if n_devices is not None:
        return int(n_devices)
    return int(np.prod(shape)) if shape is not None else 1


def _enumerate(device, n_devices=None, shape=None) -> list:
    """The devices a mesh may take: every card of this host, or the CPU
    positions.  Raises ``BackendUnavailableError`` when there are none
    (through ``faults.fire("mesh.provision")``, the test seam)."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        # api-edge: documented device-selection contract
        raise ValueError(f"a mesh is made of cuda or cpu devices, not {dev}")
    if dev.type == "cuda" and dev.index is not None:
        # api-edge: documented mesh-provisioning contract
        raise ValueError(
            "make_mesh enumerates every card of this host; build "
            "Mesh(devices) to pick cards")
    try:
        fire("mesh.provision")
        if dev.type == "cpu":
            return [dev] * _cpu_count(n_devices, shape)
        if not torch.cuda.is_available():
            raise BackendUnavailableError("CUDA is not available")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    except Exception as e:  # fallback-ok: typed re-raise, any runtime error
        raise BackendUnavailableError(
            f"mesh provisioning failed: could not enumerate devices "
            f"({type(e).__name__}: {e})") from e


def mesh_shape(n_devices: int) -> tuple[int, int]:
    """``make_mesh``'s factorization of ``n_devices`` positions: the
    points axis 2 when the count is even, else 1; keys take the rest."""
    points = 2 if n_devices % 2 == 0 else 1
    return n_devices // points, points


def make_mesh(n_devices: int | None = None,
              axis_names: tuple[str, str] = ("keys", "points"),
              shape: tuple[int, int] | None = None,
              device="cuda") -> Mesh:
    """A 2D (keys x points) mesh over the first devices.

    ``shape=(keys_dim, points_dim)`` pins the factorization.  Without
    it, the points axis is 2 when the count is even and 1 otherwise, and
    the keys axis takes the rest: ``make_mesh(8)`` is {keys: 4,
    points: 2}.  Asking for more devices than there are raises
    ``ValueError``; no device repeats.  ``device="cpu"`` makes CPU
    positions (``n_devices`` of them, else ``DCF_CPU_DEVICES``, else 1,
    and at most ``DCF_CPU_DEVICES`` where it is set)."""
    devs = _enumerate(device, n_devices, shape)
    if shape is not None:
        keys_dim, points = shape
        if n_devices is not None and keys_dim * points != n_devices:
            raise ValueError(  # api-edge: documented mesh-shape contract
                f"mesh shape {shape} does not cover {n_devices} devices")
    else:
        keys_dim, points = mesh_shape(
            len(devs) if n_devices is None else n_devices)
    if keys_dim * points > len(devs):
        raise ValueError(  # api-edge: documented mesh-provisioning contract
            f"requested {keys_dim * points} devices, have {len(devs)}")
    grid = np.empty((keys_dim, points), dtype=object)
    for q in range(keys_dim * points):
        grid[q // points, q % points] = devs[q]
    return Mesh(grid, axis_names)


def make_pod_mesh(axis_names: tuple[str, str] = ("keys", "points"),
                  shape: tuple[int, int] | None = None,
                  device="cuda") -> Mesh:
    """The pod mesh: every device of every process of the group.

    Under a ``torch.distributed`` group each process contributes one
    position, its ``device`` (``cuda`` names the card of index rank %
    cards; ``cpu`` a CPU position); the processes exchange their device
    names once (``all_gather_object``, so every process must call this).
    Standalone, the pod is this host's devices (``make_mesh``'s
    enumeration).  The default shape is (1, devices): the ring shards
    keys across hosts, the pod mesh shards points.  ``shape`` must cover
    every device exactly."""
    if _compat.group_backend() is None:
        devs = _enumerate(device)
    else:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            if not torch.cuda.is_available():
                raise BackendUnavailableError(
                    "pod mesh provisioning failed: CUDA is not available")
            dev = torch.device(
                "cuda", _compat.process_index() % torch.cuda.device_count())
        try:
            fire("mesh.provision")
            import torch.distributed as dist

            names = [None] * _compat.process_count()
            dist.all_gather_object(names, str(dev))
        except Exception as e:  # fallback-ok: typed re-raise, any
            # runtime or collective error
            raise BackendUnavailableError(
                f"pod mesh provisioning failed: could not gather the "
                f"processes' devices ({type(e).__name__}: {e})") from e
        devs = [torch.device(n) for n in names]
    n = len(devs)
    if shape is None:
        keys_dim, points = 1, n
    else:
        keys_dim, points = shape
        if keys_dim * points != n:
            raise ValueError(  # api-edge: documented pod-mesh contract
                f"pod mesh shape {shape} does not cover all {n} global "
                f"devices")
    grid = np.empty((keys_dim, points), dtype=object)
    for q in range(n):
        grid[q // points, q % points] = devs[q]
    return Mesh(grid, axis_names)


def key_slice(bundle: KeyBundle, lo: int, hi: int) -> KeyBundle:
    """Keys lo..hi-1 of ``bundle`` (the bundle itself when that is all
    of it)."""
    if lo == 0 and hi == bundle.num_keys:
        return bundle
    return KeyBundle(s0s=bundle.s0s[lo:hi], cw_s=bundle.cw_s[lo:hi],
                     cw_v=bundle.cw_v[lo:hi], cw_t=bundle.cw_t[lo:hi],
                     cw_np1=bundle.cw_np1[lo:hi], group=bundle.group)


class ShardedTensor:
    """A sharded ``eval_staged`` result: ``blocks[i][j]`` is the block of
    key shard i and point shard j, uint8 [rows, points, lam], on its
    position's device; ``rows[i]`` of key shard i's rows are real keys
    (the rest pad keys, dropped by ``to_bytes``).  Laid end to end, the
    blocks are the unsharded [K, M_pad, lam]."""

    def __init__(self, blocks, rows=None):
        self.blocks = [list(r) for r in blocks]
        self.rows = (list(rows) if rows is not None
                     else [r[0].shape[0] for r in self.blocks])

    @property
    def shape(self) -> tuple[int, int, int]:
        first = self.blocks[0]
        return (sum(self.rows), sum(b.shape[1] for b in first),
                first[0].shape[2])

    def to_bytes(self, m: int) -> np.ndarray:
        """The host bytes uint8 [K, m, lam]: the blocks in key-shard and
        point-shard order, pad keys and pad points dropped.  Every
        position's kernels were launched before the first copy waits."""
        if len(self.blocks) == 1 and len(self.blocks[0]) == 1:
            return self.blocks[0][0][:self.rows[0], :m].cpu().numpy()
        rows = [np.concatenate([b.cpu().numpy() for b in blocks],
                               axis=1)[:r]
                for blocks, r in zip(self.blocks, self.rows)]
        return np.concatenate(rows, axis=0)[:, :m]

    def pair_combine(self, group: str) -> "ShardedTensor":
        """The protocols' pairwise combine (keys 2i and 2i+1 into row i)
        shard by shard, where every key shard holds whole pairs of real
        keys; otherwise each point shard's key blocks come together on
        its first key shard's device first."""
        width = group_width(group)
        if all(r % 2 == 0 for r in self.rows):
            return ShardedTensor(
                [[group_add_plain(b[0:r:2], b[1:r:2], width) for b in blks]
                 for blks, r in zip(self.blocks, self.rows)],
                [r // 2 for r in self.rows])
        if sum(self.rows) % 2:
            raise ShapeError(f"expected [2m, M, lam] bound-key shares, got "
                             f"{sum(self.rows)} keys")
        cols = []
        for j in range(len(self.blocks[0])):
            dev = self.blocks[0][j].device
            y = torch.cat([blks[j][:r].to(dev) for blks, r in
                           zip(self.blocks, self.rows)])
            cols.append(group_add_plain(y[0::2], y[1::2], width))
        return ShardedTensor([cols])


class ShardedBase:
    """The per-position map the sharded classes share: one backend
    instance for each (key shard, device) of the mesh, made by
    ``_make(device)``, and this process's positions (every position but
    on a pod mesh, ``mesh_eval``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        kaxis, paxis = mesh.axis_names
        self._ksize = mesh.shape[kaxis]
        self._psize = mesh.shape[paxis]
        self._cols = self._columns()
        self._insts: dict = {}

    def _make(self, device: torch.device):
        raise NotImplementedError

    def _columns(self):
        """The points-axis columns this process runs: all of them."""
        return range(self._psize)

    def _positions(self) -> list[tuple[int, int, torch.device]]:
        """This process's (key shard, point shard, device) positions, in
        row-major order."""
        return [(i, j, self.mesh.devices[i, j])
                for i in range(self._ksize) for j in self._cols]

    def _inst(self, i: int, device: torch.device):
        key = (i, device)
        be = self._insts.get(key)
        if be is None:
            with warnings.catch_warnings():  # the sharded class warned
                warnings.simplefilter("ignore", ReferenceContractWarning)
                be = self._insts[key] = self._make(device)
        return be

    def _each_inst(self):
        """(key shard, instance) of every instance this process uses."""
        seen = {}
        for i, _j, dev in self._positions():
            seen.setdefault((i, dev), (i, self._inst(i, dev)))
        return list(seen.values())

    def shard_backends(self) -> list:
        """The instances holding this backend's device state (the serve
        registry's image accounting sums theirs)."""
        return [be for _i, be in self._each_inst()]

    def _split_shared(self, xs: np.ndarray, tile: int):
        """Shared points [M, nb] padded so that each of this process's
        point shards gets the same whole number of ``tile``-point tiles
        (pad points are x = 0), cut into those shards:
        ({column: slice [w, nb]}, m, w)."""
        m = xs.shape[0]
        n_cols = len(self._cols)
        g = n_cols * tile
        m_pad = max(-(-m // g) * g, g)
        if m_pad != m:
            xs = np.pad(xs, [(0, m_pad - m), (0, 0)])
        w = m_pad // n_cols
        return ({j: xs[c * w:(c + 1) * w] for c, j in enumerate(self._cols)},
                m, w)

    def staged_to_bytes(self, y: ShardedTensor, m: int) -> np.ndarray:
        """``eval_staged`` output -> uint8 [K, m, lam] on the host."""
        return y.to_bytes(m)

    def _count(self, counts) -> torch.Tensor:
        """The sum of per-position device counts, on the first
        position's device."""
        dev = self._positions()[0][2]
        return torch.stack([c.to(dev) for c in counts]).sum()

    @staticmethod
    def _on(dev: torch.device, y: torch.Tensor) -> torch.Tensor:
        """``y`` if it lies on its position's device ``dev``."""
        if y.device != dev:
            raise BackendUnavailableError(
                f"a shard's output is on {y.device}, its position is {dev}")
        return y


class ShardedWalkBackend(ShardedBase):
    """The from-root walk (B1 at lam = 16, E1 at lam = 32) over a
    (keys, points) mesh.  Keys shard over ``keys``: each key shard's
    image lives on the devices of its row.  Points shard over
    ``points``: shared points [M, nb] or per-key points [K, M, nb],
    padded so that every point shard is a whole number of 32-point
    warps (pad points are x = 0 evaluations, dropped at
    ``staged_to_bytes``).  Every group the walk takes.  The key count
    must divide the keys axis."""

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], mesh: Mesh):
        super().__init__(mesh)
        if lam not in (16, 32):
            # api-edge: constructor lam contract
            raise ValueError(
                f"ShardedWalkBackend supports lam=16 and lam=32 (got "
                f"{lam}); lam >= 48 is ShardedLargeLambdaBackend's")
        hirose_used_cipher_indices(lam, len(cipher_keys))
        self.lam = lam
        self.cipher_keys = list(cipher_keys)
        self._bundle_dims = None
        self._group = "xor"
        self._each_inst()  # build every position's backend now

    def _make(self, device):
        return WalkBackend(self.lam, self.cipher_keys, device=device)

    def put_bundle(self, bundle: KeyBundle) -> None:
        """Ship a party-restricted bundle, key shard i's keys to the
        devices of row i."""
        if bundle.lam != self.lam:
            raise ShapeError("bundle lam mismatch")
        if bundle.num_keys % self._ksize:
            raise ShapeError(
                f"num_keys={bundle.num_keys} not divisible by keys-axis "
                f"size {self._ksize}")
        per = bundle.num_keys // self._ksize
        for i, be in self._each_inst():
            be.put_bundle(key_slice(bundle, i * per, (i + 1) * per))
        self._bundle_dims = (bundle.num_keys, bundle.n_bits)
        self._group = bundle.group

    def _dims(self) -> tuple[int, int]:
        if self._bundle_dims is None:
            raise StaleStateError(
                "no key bundle on device; call put_bundle first")
        return self._bundle_dims

    def stage(self, xs) -> dict:
        """Ship each position's point slice to its device."""
        k_num, n = self._dims()
        xs = np.asarray(xs)
        if xs.dtype != np.uint8:
            raise ShapeError(f"xs must be uint8, got {xs.dtype}")
        if xs.ndim not in (2, 3):
            raise ShapeError(f"xs must be 2D or 3D, got {xs.ndim}D")
        shared = xs.ndim == 2
        if not shared and xs.shape[0] != k_num:
            raise ShapeError(
                f"xs has {xs.shape[0]} key rows but bundle has {k_num} "
                "keys")
        if xs.shape[-1] * 8 != n:
            raise ShapeError("xs width mismatch with bundle")
        m = xs.shape[0] if shared else xs.shape[1]
        if m == 0:
            raise ShapeError("cannot stage an empty batch")
        per = k_num // self._ksize
        # Cut per-key points along the point axis by cutting each key's
        # row: the same split a shared batch gets.
        flat = xs if shared else xs.transpose(1, 0, 2).reshape(m, -1)
        cols, m, w = self._split_shared(flat, POINT_TILE)
        parts = {}
        for i, j, dev in self._positions():
            part = cols[j]
            if not shared:
                part = part.reshape(w, k_num, -1).transpose(1, 0, 2)[
                    i * per:(i + 1) * per]
            parts[(i, j)] = self._inst(i, dev).stage(
                np.ascontiguousarray(part))
        return {"parts": parts, "m": m}

    def eval_staged(self, b: int, staged: dict) -> ShardedTensor:
        """Party ``b`` on every position: the kernels of all positions
        are launched before anything waits on them."""
        self._dims()
        blocks = {}
        for i, j, dev in self._positions():
            blocks[(i, j)] = self._on(dev, self._inst(i, dev).eval_staged(
                b, staged["parts"][(i, j)]))
        return _grid(blocks, self._positions())

    def eval(self, b: int, xs, bundle: KeyBundle | None = None) -> np.ndarray:
        """Party ``b``; xs uint8 [M, nb] or [K, M, nb] -> uint8
        [K, M, lam]."""
        if bundle is not None:
            self.put_bundle(bundle)
        xs = np.asarray(xs)
        m = xs.shape[0] if xs.ndim == 2 else xs.shape[-2]
        if m == 0:
            return np.zeros((self._dims()[0], 0, self.lam), dtype=np.uint8)
        staged = self.stage(xs)
        return self.staged_to_bytes(self.eval_staged(b, staged), staged["m"])

    def points_mismatch_count(self, y0: ShardedTensor, y1: ShardedTensor,
                              alpha, beta, staged: dict,
                              gt: bool = False) -> torch.Tensor:
        """The two-party check of ``WalkBackend.points_mismatch_count``
        on every position, pad points included, summed."""
        return self._count(_shard_counts(
            self, y0, y1, alpha, beta, staged, self._dims()[0], self._group,
            gt))


def _grid(blocks: dict, positions, rows=None) -> ShardedTensor:
    """The ``ShardedTensor`` of the blocks {(i, j): tensor} of
    ``positions``; ``rows``: the real keys of each key shard."""
    keys = sorted({i for i, _j, _d in positions})
    cols = sorted({j for _i, j, _d in positions})
    return ShardedTensor([[blocks[(i, j)] for j in cols] for i in keys],
                         rows)


def _shard_counts(be, y0: ShardedTensor, y1: ShardedTensor, alpha, beta,
                  staged: dict, k_num: int, group: str, gt: bool) -> list:
    """Each position's ``points_mismatch_count`` over its block and its
    staged points, its key shard's alphas and betas (bytes for a single
    key)."""
    single = isinstance(alpha, (bytes, bytearray))
    per = k_num // be._ksize
    counts = []
    for i in range(be._ksize):
        a = alpha if single else np.asarray(alpha)[i * per:(i + 1) * per]
        bt = beta if single else np.asarray(beta)[i * per:(i + 1) * per]
        for ci, j in enumerate(be._cols):
            counts.append(points_mismatch_count(
                y0.blocks[i][ci], y1.blocks[i][ci], a, bt,
                staged["parts"][(i, j)]["xs"], be.lam, group, gt))
    return counts
