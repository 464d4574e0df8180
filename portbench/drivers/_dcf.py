"""What the DCF drivers share: the inputs made from the seed, the facade
and its keys, the refresh of a batch between requests, the sample, and
the summary of each request's points for the trace's readers.

Inputs.  ``cell.rng["inputs"]`` gives the cipher keys, alphas, betas and
root seeds of ``num_keys`` keys; ``cell.rng["points"]`` the traffic's
``batches`` base batches of ``points`` points and the refresh masks;
``cell.rng["sample"]`` the sample plan: for each of ``SAMPLE_MAX``
sampled requests, ``sample_keys`` keys and ``sample_points`` points.

Fresh points.  No request repeats the points of another.  Request i
evaluates batch i mod ``batches``; after that use, and before the
batch's next, its points are XORed with the next refresh mask, a random
word that leaves the top k bits (the program's frontier depth, 0
without one) alone and changes the rest.  So a batch never comes back with points it
has already been asked, and a cache of answers by batch or by point
cannot serve one; the top k bits that fix the frontier rows a point
gathers stay as the seed drew them.  The harness keeps each batch's
running mask, so the points of every request are known on the host.
"""

from __future__ import annotations

import numpy as np

from portbench import roofline

__all__ = ["make_inputs", "build_facade", "frontier_depth", "keep_mask",
           "points_of", "next_mask", "refresh_host", "log", "gather",
           "query", "points_summary", "geometry", "MASKS"]

MASKS = 1 << 16  # refresh masks drawn from the seed; used in turn
TILE = 8192  # words of a host refresh's row: numpy XORs long rows fast


def make_inputs(cell) -> None:
    """The keys' material, the base batches, the masks and the sample plan
    of ``cell``, all from its seed."""
    cfg, tr = cell.config, cell.traffic
    nb, lam, k_num = int(cfg["n_bytes"]), int(cfg["lam"]), int(
        cfg["num_keys"])
    rng = cell.rng["inputs"]
    cipher_keys = [rng.bytes(32) for _ in range(int(cfg["cipher_keys"]))]
    cell.inputs = {
        "cipher_keys": cipher_keys, "party": int(cfg["party"]),
        "bound": cfg["bound"], "group": cfg["group"],
        "alphas": rng.integers(0, 256, (k_num, nb), dtype=np.uint8),
        "betas": rng.integers(0, 256, (k_num, lam), dtype=np.uint8),
        "s0s": rng.integers(0, 256, (k_num, 2, lam), dtype=np.uint8)}
    m = int(tr["points"])
    rng = cell.rng["points"]
    host = cell.host
    host["base"] = [np.frombuffer(bytearray(rng.bytes(m * nb)),
                                  dtype=np.uint8).reshape(m, nb)
                    for _ in range(int(tr["batches"]))]
    host["masks"] = rng.integers(0, 256, (MASKS, nb), dtype=np.uint8)
    host["running"] = [np.zeros(nb, np.uint8) for _ in host["base"]]
    host["log"] = []  # (batch, its running mask) of every request
    rng = cell.rng["sample"]
    host["plan"] = [
        (np.sort(rng.choice(k_num, int(tr["sample_keys"]), replace=False)),
         np.sort(rng.choice(m, int(tr["sample_points"]), replace=False)))
        for _ in range(cell.SAMPLE_MAX)]
    cell.evals_per_request = k_num * m


def build_facade(cell, mark) -> None:
    """``Dcf`` on the configuration's backend, and the keys by ``Dcf.gen``
    from the seeded alphas, betas and root seeds."""
    from dcf_tpu_torch.api import Dcf
    from dcf_tpu_torch.spec import Bound

    cfg, inp = cell.config, cell.inputs
    dcf = Dcf(int(cfg["n_bytes"]), int(cfg["lam"]), inp["cipher_keys"],
              backend=cfg["backend"], device=cell.device)
    cell.state["dcf"] = dcf
    cell.state["bundle"] = dcf.gen(inp["alphas"], inp["betas"],
                                   s0s=inp["s0s"], bound=Bound[cfg["bound"]],
                                   group=cfg["group"])
    mark("facade and keygen")


def frontier_depth(cell) -> int:
    """k, the levels the program's backend expands once per key into a
    frontier (0 for a backend without one); read once its keys are on
    the device."""
    if "k" not in cell.host:
        be = cell.state["dcf"].eval_backend(cell.inputs["party"])
        cell.host["k"] = int(be._k()) if hasattr(be, "_k") else 0
    return cell.host["k"]


def keep_mask(k: int, nb: int) -> np.ndarray:
    """uint8 [nb]: 0 in the top k bits (MSB first), 1 from level k on."""
    bits = np.zeros(8 * nb, np.uint8)
    bits[k:] = 1
    return np.packbits(bits)


def points_of(cell, batch: int) -> np.ndarray:
    """The points batch ``batch`` holds now, on the host."""
    return cell.host["base"][batch] ^ cell.host["running"][batch]


def next_mask(cell, i: int) -> np.ndarray:
    """The refresh mask after request i: the seed's i-th, top k bits
    cleared."""
    host = cell.host
    if "keep" not in host:
        host["keep"] = keep_mask(frontier_depth(cell), host["masks"].shape[1])
    mask = host["masks"][i % MASKS] & host["keep"]
    host["running"][i % len(host["base"])] ^= mask
    return mask


def refresh_host(cell, i: int, xs: np.ndarray) -> None:
    """XOR request i's batch ``xs`` (the host array the program reads) in
    place with the next mask."""
    mask = next_mask(cell, i)
    if xs.shape[1] % 8:
        np.bitwise_xor(xs, mask, out=xs)
        return
    # A word at a time, the mask tiled over rows of TILE words where the
    # batch divides into them (a row of one point's 2 words is 5-10x
    # slower in numpy).
    words = mask.view(np.uint64)
    flat = xs.reshape(-1).view(np.uint64)
    reps = (TILE // words.size
            if TILE % words.size == 0 and flat.size % TILE == 0 else 1)
    tile = np.tile(words, reps)
    rows = flat.reshape(-1, tile.size)
    np.bitwise_xor(rows, tile, out=rows)


def log(cell, i: int) -> int:
    """Record which batch request i evaluates, and with what mask."""
    batch = i % len(cell.host["base"])
    cell.host["log"].append((batch, cell.host["running"][batch].copy()))
    return batch


def gather(cell, out, plan: int):
    """The planned keys' answers at the planned points of ``out`` (uint8
    [K, M(_pad), lam], device or host), or None where ``out`` is not
    whole."""
    ks, ps = cell.host["plan"][plan]
    k_num, lam = cell.inputs["betas"].shape
    m = cell.host["base"][0].shape[0]
    if out.shape[0] != k_num or out.shape[1] < m or out.shape[2] != lam:
        return None
    if isinstance(out, np.ndarray):
        return out[np.ix_(ks, ps)]
    dev = cell.state.setdefault("plan_dev", {})
    if plan not in dev:
        import torch

        dev[plan] = (torch.from_numpy(ks).to(out.device),
                     torch.from_numpy(ps).to(out.device))
    kd, pd = dev[plan]
    return out.index_select(0, kd).index_select(1, pd)


def query(cell, i: int, plan: int) -> tuple[dict, int]:
    """(what the reference reads, answers) for request i's planned keys
    and points: the keys' indices and the points as request i saw them."""
    batch, running = cell.host["log"][i]
    ks, ps = cell.host["plan"][plan]
    return ({"keys": ks, "xs": cell.host["base"][batch][ps] ^ running},
            len(ks) * len(ps))


def points_summary(cell, calls) -> list[dict]:
    """For each request in ``calls``, what a walk kernel's work depends
    on: m, the 1-bits of each bit column (MSB first) of its points, and
    the distinct top-k prefixes (frontier rows) among them.  XOR with a
    mask flips whole columns, so the counts follow from the base batch's."""
    k = frontier_depth(cell)
    base = [(roofline.column_ones(xs), roofline.prefix_rows(xs, k))
            for xs in cell.host["base"]]
    out = []
    for i in calls:
        batch, running = cell.host["log"][i]
        ones, rows = base[batch]
        m = cell.host["base"][batch].shape[0]
        flip = np.unpackbits(running).astype(bool)
        out.append({"m": m, "ones": np.where(flip, m - ones, ones),
                    "rows": rows})
    return out


def geometry(cell) -> dict:
    """The cell's shape for the trace's readers: n, nb and the frontier
    depth k."""
    nb = int(cell.config["n_bytes"])
    return {"n": 8 * nb, "nb": nb, "k": frontier_depth(cell)}
