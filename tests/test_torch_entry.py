"""The port's entry point (``dcf_tpu_torch.entry``) and device
provisioning (``dcf_tpu_torch.utils.provision``) against ``dcf_tpu``'s.

``entry(device="cpu")`` runs kernel B1's plain PyTorch version; its
shares, decoded to bytes, must equal ``dcf_tpu``'s numpy oracle of party
0 on ``__graft_entry__._make_workload`` byte for byte (integer
cryptography: exact equality)."""

import numpy as np
import pytest
import torch

from __graft_entry__ import _make_workload as j_make_workload
from dcf_tpu.backends.numpy_backend import eval_batch_np as j_eval_np

from dcf_tpu_torch.backends._common import resolve_device
from dcf_tpu_torch.entry import _make_workload as t_make_workload
from dcf_tpu_torch.entry import entry, main
from dcf_tpu_torch.errors import BackendUnavailableError
from dcf_tpu_torch.utils import provision
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_entry_cpu_matches_dcf_tpu_numpy_oracle():
    fn, example_args = entry(device="cpu")
    assert all(a.device.type == "cpu" for a in example_args)
    y = fn(*example_args)
    assert y.dtype == torch.uint8 and y.shape[0] == 2
    _ck, prg, _a, _b, bundle, xs = j_make_workload(2, 16, 16, 64)
    want = j_eval_np(prg, 0, bundle.for_party(0), xs)
    assert want.shape == (2, 64, 16)
    np.testing.assert_array_equal(y[:, :64].numpy(), want)


@pytest.mark.parametrize("seed", [0, 7])
def test_make_workload_matches_graft_entry(seed):
    got = t_make_workload(2, 16, 16, 64, seed=seed)
    want = j_make_workload(2, 16, 16, 64, seed=seed)
    assert got[0] == want[0]  # cipher keys
    for g, w in zip(got[2:4], want[2:4]):  # alphas, betas
        np.testing.assert_array_equal(g, w)
    assert got[4].to_bytes() == want[4].to_bytes()  # DCFK frames
    np.testing.assert_array_equal(got[5], want[5])  # points


def test_entry_script_prints_shape(capsys):
    assert main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == (
        "entry OK: (2, 64, 16) torch.uint8")


def test_select_device():
    # One device rule for the CLI, entry() and every backend.
    assert provision.select_device is resolve_device
    assert provision.select_device("cpu") == torch.device("cpu")
    for bad in ("tpu", "mps:0", "nonsense"):
        with pytest.raises(ValueError):
            provision.select_device(bad)
    if torch.cuda.is_available():
        assert provision.select_device("cuda").type == "cuda"
        with pytest.raises(BackendUnavailableError):
            provision.select_device(f"cuda:{torch.cuda.device_count()}")
    else:
        # No fallback: a CUDA request on a host without CUDA raises.
        for spec in (None, "cuda", "cuda:0"):
            with pytest.raises(BackendUnavailableError):
                provision.select_device(spec)
        with pytest.raises(BackendUnavailableError):
            entry()
    assert provision.repo_cache_dir().endswith("_build")


def test_dryrun_multichip_on_four_cpu_positions(capfd, monkeypatch):
    """``dryrun_multichip(4, device="cpu")``
    (``__graft_entry__.dryrun_multichip``'s counterpart) exits 0 in its
    subprocess on four CPU positions and prints one OK line per sharded
    class, per facade route and per negative control.  The subprocess
    runs torch on one thread, as this module's tests do
    (``one_torch_thread``): beside the suite's other workers a thread a
    core thrashes."""
    from dcf_tpu_torch.entry import dryrun_multichip

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    dryrun_multichip(4, device="cpu")
    out = capfd.readouterr().out
    tags = [line.split("[", 1)[1].split("]", 1)[0]
            for line in out.splitlines()
            if line.startswith("dryrun_multichip OK [")]
    assert tags == [
        "ShardedWalkBackend", "ShardedKeyLanesBackend",
        "ShardedLargeLambdaBackend", "ShardedPrefixBackend",
        "ShardedTreeFullDomain", "ShardedDpfEvalAll",
        "Dcf facade mesh={'keys': 2, 'points': 2} -> walk",
        "negative control", "negative control keylanes",
        "negative control prefix"], out


def test_dryrun_multichip_runs_on_the_card_unless_asked(monkeypatch):
    """The dry run asks for the card by default (no fallback: without
    CUDA its subprocess fails and it raises) and for CPU positions only
    through ``device="cpu"`` or ``DCF_CPU_DEVICES``."""
    from dcf_tpu_torch import entry as entry_mod

    runs = []
    monkeypatch.setattr(entry_mod.subprocess, "run", lambda argv, **kw: (
        runs.append((argv[-1].split("; ")[1],
                     kw["env"].get("DCF_CPU_DEVICES")))
        or type("Done", (), {"returncode": 0})()))
    monkeypatch.delenv("DCF_CPU_DEVICES", raising=False)
    entry_mod.dryrun_multichip(4)
    entry_mod.dryrun_multichip(2, device="cpu")
    monkeypatch.setenv("DCF_CPU_DEVICES", "8")
    entry_mod.dryrun_multichip(4)
    entry_mod.dryrun_multichip(4, device="cuda")
    assert runs == [("_dryrun_multichip_impl(4, 'cuda')", None),
                    ("_dryrun_multichip_impl(2, 'cpu')", "2"),
                    ("_dryrun_multichip_impl(4, 'cpu')", "4"),
                    ("_dryrun_multichip_impl(4, 'cuda')", None)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        entry_mod.dryrun_multichip(4, device="tpu")
    monkeypatch.undo()
    if not torch.cuda.is_available():
        monkeypatch.delenv("DCF_CPU_DEVICES", raising=False)
        with pytest.raises(RuntimeError, match="rc=1"):
            entry_mod.dryrun_multichip(4)


@pytest.mark.parametrize("n_cards", [1, 2, 4])
def test_dryrun_mesh_lays_the_cards_over_the_positions(n_cards):
    """Four positions (2 x 2) and a 1 x 4 row over ``n_cards`` cards:
    each position takes card q % n_cards, so one card repeats in every
    position and four cards give each position its own."""
    from dcf_tpu_torch.entry import _dryrun_mesh

    cards = [torch.device("cuda", i) for i in range(n_cards)]
    for shape, mesh in (((2, 2), _dryrun_mesh(4, cards)),
                        ((1, 4), _dryrun_mesh(4, cards, shape=(1, 4)))):
        assert mesh.devices.shape == shape
        assert [d.index for d in mesh.devices.reshape(-1)] == [
            q % n_cards for q in range(4)]


def test_force_cpu_devices_sets_the_port_variable():
    env = {}
    provision.force_cpu_devices(env, 4)
    assert env == {"DCF_CPU_DEVICES": "4"}
