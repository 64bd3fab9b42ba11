"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them: ``python -m pytest --noconftest tests/test_torch_kernels.py``.
Tests marked ``cuda`` need a GPU and skip without one; the others check the
wrappers' CPU route and input validation.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cdsegnet_torch.ops.attention import patch_attention  # noqa: E402
from cdsegnet_torch.ops.flash_attention import (  # noqa: E402
    _check,
    patch_attention_fwd,
)

torch.set_num_threads(2)


def attention_inputs(n, h, d, patch, scene_sizes, seed=0, device="cpu"):
    """Random q, k, v and sorted scene ids/validity: scenes back to back,
    crossing patch boundaries, padding with the sentinel id at the tail."""
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(n, h, d).astype(np.float32)).to(device)
               for _ in range(3))
    batch = np.full(n, len(scene_sizes), np.int32)
    start = 0
    for s, size in enumerate(scene_sizes):
        batch[start:start + size] = s
        start += size
    valid = torch.from_numpy(np.arange(n) < start).to(device)
    return q, k, v, torch.from_numpy(batch).to(device), valid


CASES = [(2048, 2, 16, 512, [700, 900, 250]), (1024, 4, 32, 256, [500, 421])]


@pytest.mark.parametrize("case", CASES)
def test_wrapper_runs_the_plain_version_on_cpu(case):
    n, h, d, patch, sizes = case
    q, k, v, b, m = attention_inputs(n, h, d, patch, sizes)
    for upcast in (True, False):
        got = patch_attention_fwd(q, k, v, b, m, patch, d ** -0.5,
                                  upcast_softmax=upcast)
        want = patch_attention(q, k, v, b, m, patch, d ** -0.5,
                               upcast_softmax=upcast)
        assert torch.equal(got, want)


@pytest.mark.parametrize("bad,error", [
    ("dtype", TypeError), ("head_dim", ValueError), ("patch", ValueError),
    ("batch_dtype", TypeError), ("stride", ValueError)])
def test_kernel_inputs_are_checked(bad, error):
    n, h, d, patch = 512, 2, 16, 128
    q, k, v, b, m = attention_inputs(n, h, d, patch, [400])
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = (x.reshape(n, 4, 8) for x in (q, k, v))
    elif bad == "patch":
        patch = 300
    elif bad == "batch_dtype":
        b = b.long()
    else:
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(error):
        _check(q, k, v, b, m, patch)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_on_gpu(cuda_device, case, dtype):
    n, h, d, patch, sizes = case
    q, k, v, b, m = attention_inputs(n, h, d, patch, sizes, device=cuda_device)
    dt = getattr(torch, dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    before = patch_attention_fwd.launches
    with torch.no_grad():
        got = patch_attention_fwd(q, k, v, b, m, patch, d ** -0.5).float()
    torch.cuda.synchronize()
    assert patch_attention_fwd.launches == before + 1
    want = patch_attention(q, k, v, b, m, patch, d ** -0.5,
                           upcast_softmax=True).float()
    assert torch.isfinite(got).all()  # padding rows are written as zeros
    assert (got[~m] == 0).all()
    err = (got - want)[m].abs().max().item()
    # f32: f32 arithmetic on both sides; bf16: the plain version rounds the
    # probabilities to bf16 before p.v
    tol = 1e-4 if dtype == "float32" else 2e-2 * want[m].abs().max().item()
    assert err <= tol


@pytest.mark.cuda
def test_kernel_refuses_gradients(cuda_device):
    q, k, v, b, m = attention_inputs(512, 2, 16, 128, [400], device=cuda_device)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward kernel"):
        patch_attention_fwd(q, k, v, b, m, 128, 0.25)
