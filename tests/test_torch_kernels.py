"""The port's CUDA kernels against their plain PyTorch versions.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them: ``python -m pytest --noconftest tests/test_torch_kernels.py``.
Tests marked ``cuda`` need a GPU and skip without one; the others check the
wrappers' CPU route and input validation.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cdsegnet_torch.ops.attention import patch_attention  # noqa: E402
from cdsegnet_torch.ops.flash_attention import (  # noqa: E402
    SOURCES,
    _check,
    _launch_fwd,
    patch_attention_bwd_dkdv,
    patch_attention_bwd_dq,
    patch_attention_fwd,
)
from cdsegnet_torch.utils import cuda_build  # noqa: E402

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
# Layouts for the tensor-core backward's tiers of masking, on the GPU only:
# scenes crossing patches and the 16-row and 8-column fragments at odd
# offsets, padding rows at the tail; a patch of 64 (less than one streamed
# tile); a patch that is not a multiple of 16 (a ragged tail in every warp
# and tile).
BOUNDARY_CASES = [(8192, 2, 16, 1024, [2500, 3100, 1772]),
                  (2048, 4, 32, 512, [922, 921]),
                  (1024, 2, 16, 64, [101, 333, 451]),
                  (1000, 2, 32, 200, [333, 401])]
# one scene, every row valid: only the tensor-core kernels' open path (no
# per-element mask test) runs
OPEN_CASE = (4096, 2, 16, 1024, [4096])
GPU_CASES = CASES + BOUNDARY_CASES + [OPEN_CASE]


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


def test_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """A kernel builds anew when a shared header changes or is added, not
    only when its own .cu does; a file that is neither leaves it be."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    paths = lambda: [cuda_build.library_path(name) for name in SOURCES]  # noqa: E731
    before = paths()
    (csrc / "notes.txt").write_text("not a source\n")
    assert paths() == before
    header = csrc / "attention_tiles.cuh"
    header.write_text(header.read_text() + "// edited\n")
    edited = paths()
    assert all(a != b for a, b in zip(before, edited))
    (csrc / "more.cuh").write_text("#pragma once\n")
    assert all(a != b for a, b in zip(edited, paths()))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", GPU_CASES)
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


def plain_grads(q, k, v, b, m, patch, g):
    """Autograd through the plain version: the output and the gradients of
    q, k, v for output gradient ``g``."""
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    out = patch_attention(*leaves, b, m, patch, q.shape[-1] ** -0.5,
                          upcast_softmax=True)
    return (out.detach(),) + torch.autograd.grad(out, leaves, g)


def test_wrapper_backward_is_autograd_of_the_plain_version_on_cpu():
    n, h, d, patch, sizes = CASES[0]
    q, k, v, b, m = attention_inputs(n, h, d, patch, sizes)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = patch_attention_fwd(*leaves, b, m, patch, d ** -0.5)
    got = torch.autograd.grad(out, leaves, g)
    want = plain_grads(q, k, v, b, m, patch, g)[1:]
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GPU_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_match_autograd_on_gpu(cuda_device, case, dtype):
    n, h, d, patch, sizes = case
    q, k, v, b, m = attention_inputs(n, h, d, patch, sizes, device=cuda_device)
    dt = getattr(torch, dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    # g is zero on rows with no allowed key (padding), as in the model:
    # there the kernels give zeros and the plain version the uniform mean
    g = torch.randn(q.shape, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(1))
    g = torch.where(m[:, None, None], g, 0.0).to(dt)
    counts = (patch_attention_fwd.lse_launches, patch_attention_bwd_dq.launches,
              patch_attention_bwd_dkdv.launches)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = patch_attention_fwd(*leaves, b, m, patch, d ** -0.5)
    got = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    assert (patch_attention_fwd.lse_launches, patch_attention_bwd_dq.launches,
            patch_attention_bwd_dkdv.launches) == tuple(c + 1 for c in counts)
    want = plain_grads(q, k, v, b, m, patch, g)[1:]
    for name, a, w in zip("qkv", got, want):
        a, w = a.float(), w.float()
        assert torch.isfinite(a).all(), name
        assert (a[~m] == 0).all(), name  # padding rows get no gradient
        err = (a - w).abs().max().item()
        # f32: f32 arithmetic on both sides, sums in another order; bf16:
        # the plain version rounds p to bf16, the kernels take delta from
        # the bf16 output and round the gradients to bf16
        tol = 1e-4 if dtype == "float32" else 2e-2 * w.abs().max().item()
        assert err <= tol, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("case", GPU_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_log_sum_exp_on_gpu(cuda_device, case, dtype):
    n, h, d, patch, sizes = case
    q, k, v, b, m = attention_inputs(n, h, d, patch, sizes, device=cuda_device)
    dt = getattr(torch, dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    with torch.no_grad():
        _, lse = _launch_fwd(q, k, v, b, m, patch, d ** -0.5, with_lse=True)
    p = n // patch
    qp, kp = q.float().view(p, patch, h, d), k.float().view(p, patch, h, d)
    s = torch.einsum("pihd,pjhd->phij", qp, kp) * d ** -0.5
    bp = b.view(p, patch)
    allowed = (bp[:, :, None] == bp[:, None, :]) & m.view(p, 1, patch)
    s = s.masked_fill(~allowed[:, None], float("-inf"))
    want = torch.logsumexp(s, -1).permute(0, 2, 1).reshape(n, h)
    assert torch.isneginf(lse[~m]).all()
    # bf16 too: products of bf16 values are exact in the f32 accumulators,
    # and the row sum adds the f32 probabilities
    assert (lse[m] - want[m]).abs().max().item() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("case", GPU_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_kernel_is_deterministic_on_gpu(cuda_device, case, dtype):
    n, h, d, patch, sizes = case
    q, k, v, b, m = attention_inputs(n, h, d, patch, sizes, device=cuda_device)
    dt = getattr(torch, dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    for with_lse in (False, True):
        first, second = (_launch_fwd(q, k, v, b, m, patch, d ** -0.5, with_lse)
                         for _ in range(2))
        assert torch.equal(first[0], second[0])
        if with_lse:
            assert torch.equal(first[1], second[1])


@pytest.mark.cuda
def test_backward_wrappers_check_inputs_on_gpu(cuda_device):
    n, h, d, patch, sizes = CASES[0]
    q, k, v, b, m = attention_inputs(n, h, d, patch, sizes, device=cuda_device)
    lse = torch.zeros((n, h), device=cuda_device)
    with pytest.raises(ValueError, match="g must match"):
        patch_attention_bwd_dq(q, k, v, q, q.bfloat16(), lse, b, m, patch, 0.25)
    with pytest.raises(ValueError, match="contiguous"):
        patch_attention_bwd_dkdv(q, k, v, q.transpose(0, 1).contiguous()
                                 .transpose(0, 1), lse, lse, b, m, patch, 0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BOUNDARY_CASES[:2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_are_deterministic_on_gpu(cuda_device, case, dtype):
    n, h, d, patch, sizes = case
    q, k, v, b, m = attention_inputs(n, h, d, patch, sizes, device=cuda_device)
    dt = getattr(torch, dtype)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    g = torch.randn(q.shape, device=cuda_device,
                    generator=torch.Generator(cuda_device).manual_seed(2)).to(dt)
    scale = d ** -0.5
    out, lse = _launch_fwd(q, k, v, b, m, patch, scale, with_lse=True)
    runs = []
    for _ in range(2):
        dq, delta = patch_attention_bwd_dq(q, k, v, out, g, lse, b, m, patch, scale)
        runs.append((dq, delta) + patch_attention_bwd_dkdv(q, k, v, g, lse, delta,
                                                           b, m, patch, scale))
    for name, a, w in zip(("dq", "delta", "dk", "dv"), *runs):
        assert torch.equal(a, w), name


# ---------------------------------------------------------------------------
# the submanifold conv's implicit-GEMM kernels (csrc/subm_conv.cu)

# (dtype, pyramid level, C_in, C_out, table): SpUNet's f32 convs (level 0
# at 96 channels, the k125 stem from 6 channels, a pooled level with
# padding tiles), the xCPE widths of the flagship's bf16 levels, and a bf16
# k125 stem
CONV_CASES = [("float32", 0, 96, 96, "k3"), ("float32", 0, 6, 32, "stem"),
              ("float32", 1, 32, 32, "k3"), ("float32", 3, 256, 256, "k3"),
              ("bfloat16", 0, 32, 32, "k3"), ("bfloat16", 0, 64, 64, "k3"),
              ("bfloat16", 2, 128, 128, "k3"), ("bfloat16", 3, 256, 256, "k3"),
              ("bfloat16", 4, 512, 512, "k3"), ("bfloat16", 0, 6, 48, "stem")]


@pytest.fixture(scope="module")
def conv_pyramid():
    """SpUNet's pyramid of the 204,800-slot training bucket (2 scenes,
    depth 12) on the GPU: its levels and the k125 stem table."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    from cdsegnet_torch.models.spunet import SpUNet
    from cdsegnet_torch.utils.synthetic import synthetic_point_batch

    point = synthetic_point_batch(204800, 2, depth=12, seed=0, device="cuda")
    return SpUNet().precompute_geometry(point)


def conv_inputs(conv_pyramid, case, seed=0):
    dtype, level, c_in, c_out, table = case
    levels, stem = conv_pyramid
    nbr = stem if table == "stem" else levels[level].point.neighbor_idx
    mask = levels[level].point.mask
    n, k = nbr.shape
    g = torch.Generator("cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    x = (torch.randn((n, c_in), device="cuda", generator=g) * mask[:, None]).to(dt)
    w = torch.randn((k, c_in, c_out), device="cuda", generator=g) / (k * c_in) ** 0.5
    bias = torch.randn((c_out,), device="cuda", generator=g)
    dy = (torch.randn((n, c_out), device="cuda", generator=g) * mask[:, None]).to(dt)
    return nbr, mask, x, w, bias, dy


def conv_counts():
    from cdsegnet_torch.ops import subm_conv as sc

    return (sc.subm_conv_gemm_fwd.launches, sc.subm_conv_gemm_dgrad.launches,
            sc.subm_conv_gemm_wgrad.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_kernels_match_plain_on_gpu(conv_pyramid, case):
    from cdsegnet_torch.ops import subm_conv as sc

    nbr, mask, x, w, bias, dy = conv_inputs(conv_pyramid, case)
    stem, f32 = case[4] == "stem", case[0] == "float32"
    before = conv_counts()
    leaves = [x.clone().requires_grad_(not stem), w.clone().requires_grad_(True),
              bias.clone().requires_grad_(True)]
    out = sc.subm_conv_apply(*leaves[:1], nbr, *leaves[1:])
    grads = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], dy)
    torch.cuda.synchronize()
    # a forward kernel in bf16 (f32 keeps the gather + matmul), one weight
    # gradient, an input gradient only where the features need one (a
    # stem's do not)
    assert conv_counts() == (before[0] + int(not f32), before[1] + int(not stem),
                             before[2] + 1)
    d_x = None if stem else grads[0]
    d_w, d_b = grads[-2:]

    n, k = nbr.shape
    rows = torch.cat([x, x.new_zeros((1, x.shape[1]))])[nbr.long()].reshape(n, -1)
    want = sc._plain_conv(x, nbr, w, bias)
    want_dw = (rows.float().T @ dy.float()).reshape(w.shape)

    def err(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()

    if f32:
        assert torch.equal(out, want)
    kernel = sc.subm_conv_gemm_fwd(x, nbr, w, bias)
    # f32: f32 products on both sides, sums in another order; bf16: the
    # plain version rounds before its bias add, the kernel after
    for y in (out, kernel):
        assert err(y, want) <= (1e-5 if f32 else 1e-2)
        assert torch.isfinite(y).all()
    assert torch.equal(kernel[~mask].float(), bias.to(x.dtype).float().expand(
        int((~mask).sum()), -1)) if f32 else err(kernel[~mask], want[~mask]) <= 1e-2
    assert err(d_w, want_dw) <= (1e-5 if f32 else 1e-3)
    assert torch.allclose(d_b, dy.float().sum(0), rtol=1e-5, atol=1e-3)
    if d_x is not None:
        want_dx = sc._plain_conv(dy, nbr, sc.reflected_weight(w).contiguous(), None)
        assert err(d_x, want_dx) <= (1e-5 if f32 else 1e-2)
        assert (d_x[~mask] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [CONV_CASES[0], CONV_CASES[5]])
def test_conv_kernels_are_deterministic_and_add_no_sync_on_gpu(conv_pyramid, case):
    from cdsegnet_torch.ops import subm_conv as sc
    from cdsegnet_torch.utils import tracing

    nbr, _, x, w, bias, dy = conv_inputs(conv_pyramid, case, seed=1)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, bias)]
        torch.cuda.synchronize()
        with tracing.capture() as cap:
            out = sc.subm_conv_apply(leaves[0], nbr, leaves[1], leaves[2])
            runs.append((out,) + torch.autograd.grad(out, leaves, dy))
        torch.cuda.synchronize()
        assert cap.counters.get(tracing.SYNCS, 0) == 0
        bf16 = int(x.dtype == torch.bfloat16)  # f32 forwards by gather + matmul
        assert {k: v for k, v in cap.launches.items() if k.startswith("conv")} == dict(
            conv_fwd=bf16, conv_dgrad=1, conv_wgrad=1)
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    # without a gradient: the forward alone, and the same value
    with torch.no_grad():
        before = conv_counts()
        assert torch.equal(sc.subm_conv_apply(x, nbr, w, bias), runs[0][0])
        assert conv_counts() == (before[0] + bf16,) + before[1:]
