"""The port's kernels over a device mesh: prefix, keylanes, the
large-lambda hybrid, the full-domain tree and DPF EvalAll.

Counterpart of ``dcf_tpu/parallel/pallas_sharded.py`` (its sharded walk
is ``parallel.mesh.ShardedWalkBackend`` here).  Each class holds one
single-device backend instance for each (key shard, device) of its mesh
(``mesh.ShardedBase``) and runs it on each position's slice:

* ``ShardedPrefixBackend`` (B2 + B3): single-key, the keys axis is 1;
  the frontier table is key material every point shard gathers from, so
  it is built once for each distinct device (about 67 MB at k = 21), not
  once a position.  Multi-key bundles walk every key on every point
  shard.
* ``ShardedKeyLanesBackend`` (B8): keys over ``keys``, shared points over
  ``points``; a key count pads to whole 32-key words a shard (pad keys
  are zero keys, their shares dropped).
* ``ShardedLargeLambdaBackend`` (B4 + W1, or B5a + B5b + W1 with
  ``prefix_levels``): keys shard the narrow image, the wide (const, W)
  factors and the frontier tables, points the batch.
* ``ShardedTreeFullDomain`` (B2 + B2f) and ``ShardedDpfEvalAll`` (B6):
  the level-k0 frontier splits over all P positions (P a power of two).
  Position q takes the contiguous slice [q 2^c, (q + 1) 2^c) of it,
  c = k0 - log2 P, expands its disjoint subtree to the leaves, and
  checks its own leaves with the shard-aware position map
  (``_common.shard_leaf_positions``); the counts are summed.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from dcf_tpu_torch.backends._common import (
    StagedFrontierCache,
    points_mismatch_count,
    to_device,
)
from dcf_tpu_torch.backends.evalall import (
    DpfEvalAll,
    dpf_leaf_mismatch_count,
    dpf_tree_expand_np,
)
from dcf_tpu_torch.backends.fulldomain import (
    TreeFullDomain,
    leaf_mismatch_count,
    tree_expand_np,
)
from dcf_tpu_torch.backends.keylanes_backend import KeyLanesBackend
from dcf_tpu_torch.backends.large_lambda import LargeLambdaBackend
from dcf_tpu_torch.backends.prefix_backend import (
    MAX_PREFIX_LEVELS,
    PrefixBackend,
)
from dcf_tpu_torch.backends.walk_backend import POINT_TILE
from dcf_tpu_torch.errors import ShapeError, StaleStateError
from dcf_tpu_torch.keys import KeyBundle
from dcf_tpu_torch.ops.evalall_expand import evalall_expand
from dcf_tpu_torch.ops.tree_expand import tree_expand_device
from dcf_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedBase,
    ShardedTensor,
    _grid,
    _shard_counts,
    key_slice,
)
from dcf_tpu_torch.spec import (
    ReferenceContractWarning,
    hirose_used_cipher_indices,
)

__all__ = ["ShardedPrefixBackend", "ShardedKeyLanesBackend",
           "ShardedLargeLambdaBackend", "ShardedTreeFullDomain",
           "ShardedDpfEvalAll"]


class _ShardedSharedPoints(ShardedBase):
    """The staged API of the classes that take shared points [M, nb]
    only: every position stages its point slice through its instance's
    own ``stage`` and evaluates it with its ``eval_staged``."""

    lam: int
    _tile = POINT_TILE  # points a point shard holds a whole number of

    def _keys_of(self, i: int) -> int:
        """Real keys of key shard i."""
        raise NotImplementedError

    def _require(self) -> None:
        if self._bundle is None:
            raise StaleStateError(
                "no key bundle on device; call put_bundle first")

    def stage(self, xs) -> dict:
        self._require()
        xs = np.asarray(xs)
        if xs.ndim != 2:
            raise ShapeError(f"{type(self).__name__} wants shared points "
                             "[M, nb]")
        if xs.shape[0] == 0:
            raise ShapeError("cannot stage an empty batch")
        cols, m, w = self._split_shared(xs, self._tile)
        parts = {(i, j): self._inst(i, dev).stage(cols[j])
                 for i, j, dev in self._positions()}
        return {"parts": parts, "m": m, "w": w}

    def eval_staged(self, b: int, staged: dict) -> ShardedTensor:
        """Party ``b`` on every position; all kernels launched before
        anything waits on them."""
        self._require()
        blocks = {}
        for i, j, dev in self._positions():
            blocks[(i, j)] = self._on(dev, self._inst(i, dev).eval_staged(
                b, staged["parts"][(i, j)]))
        return _grid(blocks, self._positions(),
                     [self._keys_of(i) for i in range(self._ksize)])

    def eval(self, b: int, xs, bundle: KeyBundle | None = None) -> np.ndarray:
        """Party ``b`` at shared points xs uint8 [M, nb] (or [1, M, nb])
        -> uint8 [K, M, lam] on the host."""
        if bundle is not None:
            self.put_bundle(bundle)
        xs = np.asarray(xs)
        if xs.ndim == 3:
            if xs.shape[0] != 1:
                raise ShapeError(
                    f"{type(self).__name__} wants shared points; use "
                    "ShardedWalkBackend for per-key point batches")
            xs = xs[0]
        staged = self.stage(xs)
        return self.staged_to_bytes(self.eval_staged(b, staged),
                                    staged["m"])

    def invalidate_frontier(self) -> None:
        """Drop every instance's frontier tables (the serve registry's
        eviction hook)."""
        for be in self.shard_backends():
            if hasattr(be, "invalidate_frontier"):
                be.invalidate_frontier()


class ShardedPrefixBackend(_ShardedSharedPoints):
    """The prefix-shared walk (kernels B2 + B3) over a 1 x N mesh: every
    point shard gathers from the whole frontier of each key, built once a
    distinct device."""

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], mesh: Mesh,
                 prefix_levels: int = MAX_PREFIX_LEVELS,
                 host_levels: int = 6):
        super().__init__(mesh)
        if self._ksize != 1:
            raise ShapeError(
                "ShardedPrefixBackend is single-key: use a 1xN mesh "
                f"(got keys axis {self._ksize})")
        hirose_used_cipher_indices(lam, len(cipher_keys))
        self.lam = lam
        self._args = (lam, list(cipher_keys), prefix_levels, host_levels)
        self._bundle = None
        self._each_inst()

    def _make(self, device):
        lam, ck, pl, hl = self._args
        return PrefixBackend(lam, ck, prefix_levels=pl, host_levels=hl,
                             device=device)

    def _keys_of(self, i: int) -> int:
        return self._bundle.num_keys

    def put_bundle(self, bundle: KeyBundle) -> None:
        """Ship the whole bundle to every distinct device."""
        for be in self.shard_backends():
            be.put_bundle(bundle)
        self._bundle = bundle
        self._group = bundle.group

    def points_mismatch_count(self, y0, y1, alpha, beta, staged: dict,
                              gt: bool = False) -> torch.Tensor:
        """``PrefixBackend.points_mismatch_count`` on every position,
        pad points included, summed."""
        self._require()
        return self._count(_shard_counts(
            self, y0, y1, alpha, beta, staged, self._bundle.num_keys,
            self._group, gt))


class ShardedLargeLambdaBackend(_ShardedSharedPoints):
    """The large-lambda hybrid (B4 + W1 from the root, B5a + B5b + W1
    with ``prefix_levels``) over a (keys, points) mesh: each key shard's
    narrow image, wide factors and frontier tables on its row's
    devices, each point shard's batch on its column's.  The key count
    must divide the keys axis."""

    #: A device-plane image from the on-device keygen is one device's
    #: layout; the serve registry stages this backend from the host
    #: bundle.
    accepts_dev_planes = False

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], mesh: Mesh,
                 prefix_levels: int = 0):
        super().__init__(mesh)
        hirose_used_cipher_indices(lam, len(cipher_keys))
        self.lam = lam
        self._args = (lam, list(cipher_keys), prefix_levels)
        self._bundle = None
        self._each_inst()

    def _make(self, device):
        lam, ck, pl = self._args
        return LargeLambdaBackend(lam, ck, prefix_levels=pl, device=device)

    def _keys_of(self, i: int) -> int:
        return self._bundle.num_keys // self._ksize

    def put_bundle(self, bundle: KeyBundle,
                   dev_planes: dict | None = None) -> None:
        """Ship a party-restricted bundle, key shard i's keys to row i."""
        if dev_planes is not None:
            raise ShapeError(
                "dev_planes is the single-device staged layout; the "
                "sharded hybrid backend stages from the host bundle "
                "and places shards itself")
        if bundle.num_keys % self._ksize:
            raise ShapeError(
                f"num_keys={bundle.num_keys} not divisible by keys-axis "
                f"size {self._ksize}")
        per = bundle.num_keys // self._ksize
        for i, be in self._each_inst():
            be.put_bundle(key_slice(bundle, i * per, (i + 1) * per))
        self._bundle = bundle

    def points_mismatch_count(self, y0, y1, alpha, beta, staged: dict,
                              gt: bool = False) -> torch.Tensor:
        """``LargeLambdaBackend.points_mismatch_count`` on every
        position, pad points included, summed."""
        self._require()
        return self._count(_shard_counts(
            self, y0, y1, alpha, beta, staged, self._bundle.num_keys, "xor",
            gt))


class ShardedKeyLanesBackend(_ShardedSharedPoints):
    """Many keys at shared points (kernel B8) over a (keys, points)
    mesh.  As ``KeyLanesBackend``: the two-party bundle (XOR group) is
    one image both parties read.  Each key shard holds the same whole
    number of 32-key words, the last ones padded with zero keys; the
    points pad to a whole number a point shard."""

    _tile = 1

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], mesh: Mesh):
        super().__init__(mesh)
        hirose_used_cipher_indices(lam, len(cipher_keys))
        self.lam = lam
        self._args = (lam, list(cipher_keys))
        self._bundle = None
        self._per = 0
        self._each_inst()

    def _make(self, device):
        return KeyLanesBackend(*self._args, device=device)

    def _keys_of(self, i: int) -> int:
        return min(self._per, max(0, self._bundle.num_keys - i * self._per))

    @property
    def num_keys(self) -> int:
        self._require()
        return self._bundle.num_keys

    def put_bundle(self, bundle: KeyBundle) -> None:
        """Ship the two-party bundle, key shard i's keys (padded to whole
        32-key words) to row i."""
        if bundle.s0s.shape[1] != 2:
            raise ShapeError("KeyLanesBackend wants the full two-party bundle")
        k_num = bundle.num_keys
        per = 32 * -(-k_num // (32 * self._ksize))
        pad = per * self._ksize - k_num
        padded = bundle if not pad else KeyBundle(*(
            np.concatenate([a, np.zeros((pad,) + a.shape[1:], np.uint8)])
            for a in (bundle.s0s, bundle.cw_s, bundle.cw_v, bundle.cw_t,
                      bundle.cw_np1)), group=bundle.group)
        for i, be in self._each_inst():
            be.put_bundle(key_slice(padded, i * per, (i + 1) * per))
        self._bundle = bundle
        self._per = per

    def relu_mismatch_count(self, y0: ShardedTensor, y1: ShardedTensor,
                            alphas: np.ndarray, betas: np.ndarray,
                            staged: dict) -> torch.Tensor:
        """Config 5's check on every position, over its real keys and
        real points: the (key, point) pairs whose XOR reconstruction
        differs from ``beta_k if x_m < alpha_k else 0``, summed."""
        if alphas.shape[0] != self.num_keys:
            raise ShapeError(f"got {alphas.shape[0]} alphas for a bundle of "
                             f"{self.num_keys} keys")
        m, w = staged["m"], staged["w"]
        counts = []
        for i in range(self._ksize):
            r = self._keys_of(i)
            lo = i * self._per
            for ci, j in enumerate(self._cols):
                mj = min(w, max(0, m - ci * w))
                if r == 0 or mj == 0:
                    continue
                counts.append(points_mismatch_count(
                    y0.blocks[i][ci][:r, :mj], y1.blocks[i][ci][:r, :mj],
                    alphas[lo:lo + r], betas[lo:lo + r],
                    staged["parts"][(i, j)]["xs"][:, :mj], self.lam, "xor"))
        return self._count(counts)


def _full_domain_split(mesh: Mesh, host_levels):
    """(P, log2 P, host_levels) of a full-domain evaluator on ``mesh``,
    with ``dcf_tpu``'s rules: P a power of two, and at least
    5 + log2 P host levels (the default raises 6 as far as needed)."""
    p_total = mesh.size
    if p_total & (p_total - 1):
        # api-edge: documented mesh-size contract
        raise ValueError(f"device count {p_total} must be a power of 2")
    log2p = p_total.bit_length() - 1
    min_k0 = 5 + log2p
    if host_levels is None:
        host_levels = max(6, min_k0)
    if host_levels < min_k0:
        raise ValueError(  # api-edge: constructor host_levels contract
            f"host_levels={host_levels} gives some device less than "
            f"one lane word of frontier; need >= {min_k0} for "
            f"{p_total} devices")
    return p_total, log2p, host_levels


class _ShardedFullDomain(StagedFrontierCache):
    """What the two full-domain classes share: one evaluator a distinct
    device (its cipher image and CW image), each position's slice of the
    host-expanded frontier on its device, the counts summed."""

    _evaluator = None  # TreeFullDomain or DpfEvalAll

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], mesh: Mesh,
                 host_levels):
        self._ptotal, self._log2p, self.host_levels = _full_domain_split(
            mesh, host_levels)
        hirose_used_cipher_indices(lam, len(cipher_keys))
        self.mesh = mesh
        self.lam = lam
        self._devs = [mesh.devices[q // mesh.devices.shape[1],
                                        q % mesh.devices.shape[1]]
                           for q in range(self._ptotal)]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", ReferenceContractWarning)
            self._evals = {
                dev: self._evaluator(lam, cipher_keys,
                                     host_levels=self.host_levels,
                                     device=dev)
                for dev in dict.fromkeys(self._devs)}
        self._prg = next(iter(self._evals.values()))._prg

    def shard_backends(self) -> list:
        return list(self._evals.values())

    def _check_depth(self, n_bits: int, unsharded: str) -> None:
        if n_bits < self.host_levels:
            raise ShapeError(
                f"n_bits={n_bits} smaller than the {self.host_levels} "
                "host levels the mesh frontier needs; use the unsharded "
                f"{unsharded}")

    def _stage_cw(self, bundle):
        return {dev: ev._stage_cw(bundle) for dev, ev in self._evals.items()}

    def _slices(self, nodes, k0: int, axis: int):
        """Position q's slice [q 2^c, (q + 1) 2^c) of the host nodes
        along ``axis``, on its device."""
        c = k0 - self._log2p
        return [tuple(to_device(np.take(a, range(q << c, (q + 1) << c),
                                        axis=axis), dev) for a in nodes)
                for q, dev in enumerate(self._devs)]

    def _sum(self, counts) -> torch.Tensor:
        dev = self._devs[0]
        return torch.stack([c.to(dev) for c in counts]).sum()


class ShardedTreeFullDomain(_ShardedFullDomain):
    """Full-domain evaluation and verification (kernels B2 + B2f) over a
    mesh: disjoint subtrees a position, each checked against the plain
    comparison on its device.  lam = 16, one XOR-group key."""

    _evaluator = TreeFullDomain

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], mesh: Mesh,
                 host_levels: int | None = None):
        super().__init__(lam, cipher_keys, mesh, host_levels)

    def _frontier(self, bundle: KeyBundle, b: int, k0: int):
        return self._slices(tree_expand_np(self._prg, bundle, b, k0), k0, 0)

    def check_device(self, bundle: KeyBundle, alpha: int, beta: bytes,
                     n_bits: int, gt: bool = False) -> torch.Tensor:
        """Two-party full-domain reconstruction against the plain
        comparison on every position; the TOTAL mismatch count, a device
        int64 scalar (the sum of the per-position counts)."""
        self._check_depth(n_bits, "TreeFullDomain")
        if bundle.n_bits != n_bits:
            raise ShapeError("bundle depth mismatch")
        TreeFullDomain._check_xor(bundle)
        staged_cw, fronts, _parts = self._staged_for(bundle, n_bits)
        k0 = self._k0(n_bits)
        counts = []
        for q, dev in enumerate(self._devs):
            aes = self._evals[dev].aes
            ys = [tree_expand_device(aes, *staged_cw[dev], *fronts[b][q],
                                     k0=k0, n=n_bits, sliced=True)
                  for b in (0, 1)]
            counts.append(leaf_mismatch_count(
                ys[0], ys[1], int(alpha), beta, n_bits, gt,
                shard=(q, self._log2p, k0)))
        return self._sum(counts)

    def check(self, bundle: KeyBundle, alpha: int, beta: bytes,
              n_bits: int, gt: bool = False) -> int:
        return int(self.check_device(bundle, alpha, beta, n_bits, gt))


class ShardedDpfEvalAll(_ShardedFullDomain):
    """Full-domain DPF evaluation and verification (kernel B6) over a
    mesh: the K-keyed frontier's node axis splits over all positions,
    every position holding all K keys; each checks its leaves against
    the point function.  lam = 32."""

    _evaluator = DpfEvalAll

    def __init__(self, lam: int, cipher_keys: Sequence[bytes], mesh: Mesh,
                 host_levels: int | None = None):
        super().__init__(lam, cipher_keys, mesh, host_levels)

    def _frontier(self, bundle, b: int, k0: int):
        return self._slices(dpf_tree_expand_np(self._prg, bundle, b, k0),
                            k0, 1)

    def check_device(self, bundle, alphas, betas, n_bits: int
                     ) -> torch.Tensor:
        """Two-party full-domain reconstruction against the point
        function on every position; the TOTAL count of mismatching leaves
        (all keys, the whole domain), a device int64 scalar."""
        self._check_depth(n_bits, "DpfEvalAll")
        if n_bits != bundle.n_bits:
            raise ShapeError(
                f"the leaf shares exist only at full depth "
                f"{bundle.n_bits}, not at {n_bits}")
        staged_cw, fronts, _parts = self._staged_for(bundle, n_bits)
        k0 = self._k0(n_bits)
        counts = []
        for q, dev in enumerate(self._devs):
            aes = self._evals[dev].aes
            ys = [evalall_expand(aes, *staged_cw[dev], *fronts[b][q], k0=k0,
                                 k1=n_bits, sliced=True)[0]
                  for b in (0, 1)]
            counts.append(dpf_leaf_mismatch_count(
                ys[0], ys[1], alphas, betas, n_bits,
                shard=(q, self._log2p, k0)))
        return self._sum(counts)

    def check(self, bundle, alphas, betas, n_bits: int) -> int:
        return int(self.check_device(bundle, alphas, betas, n_bits))
