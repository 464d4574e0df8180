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
