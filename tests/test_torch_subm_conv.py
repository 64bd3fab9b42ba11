"""The arithmetic of the submanifold conv's GPU kernels, checked on the CPU.

The kernels (`cdsegnet_torch/csrc/subm_conv.cu`) run the input gradient as
the forward over the output gradient with the reflected weight, which holds
only over symmetric tables, and the weight gradient over 64-row tiles that
skip empty taps, summed in row splits. Here every table the port's pyramid
builds is checked to be symmetric, and the plain versions of both
gradients are held to autograd through the gather + matmul form in
float64. The kernels themselves are compared with these plain versions on
the GPU in `test_torch_kernels.py`. A tiny PTv3 in ``"cond"`` runs this
conv, never the parity-blocked forms, at its stem and its xCPEs.
"""

import pytest

torch = pytest.importorskip("torch")

from cdsegnet_torch.models import modules, ptv3  # noqa: E402
from cdsegnet_torch.models import pyramid as pyr  # noqa: E402
from cdsegnet_torch.models.builder import build_model  # noqa: E402
from cdsegnet_torch.ops.subm_conv import (  # noqa: E402
    TILE_ROWS,
    _check,
    dual_subm_conv_apply,
    reflected_weight,
    subm_conv_apply,
    tile_tap_share,
    tile_taps,
)
from cdsegnet_torch.utils.synthetic import synthetic_point_batch  # noqa: E402

torch.set_num_threads(2)


def asymmetric_entries(nbr: torch.Tensor) -> int:
    """How many entries nbr[i, k] = j lack the mirror nbr[j, K-1-k] = i."""
    n, k = nbr.shape
    hit = nbr != n
    rows = torch.arange(n)[:, None].expand(n, k)[hit]
    taps = torch.arange(k)[None].expand(n, k)[hit]
    return int((nbr[nbr[hit].long(), k - 1 - taps] != rows).sum())


def weight_grad_plain(feat, neighbor_idx, grad_out, splits: int = 1) -> torch.Tensor:
    """The weight-gradient kernel's arithmetic in plain PyTorch: split s sums
    ``x[nbr[i, k]]^T dy[i]`` over the rows of tiles s, s + splits, ... that
    read tap k; the splits are added in order. (K, C_in, C_out) in
    float32, or float64 for float64 inputs."""
    n, c_in = feat.shape
    k = neighbor_idx.shape[1]
    acc = torch.float64 if feat.dtype == torch.float64 else torch.float32
    padded = torch.cat([feat.to(acc), feat.new_zeros((1, c_in), dtype=acc)])
    on = tile_taps(neighbor_idx)
    tile_of = torch.arange(n, device=feat.device) // TILE_ROWS
    parts = torch.zeros((splits, k, c_in, grad_out.shape[1]), dtype=acc, device=feat.device)
    for s in range(splits):
        for tap in range(k):
            rows = (on[tile_of, tap] & (tile_of % splits == s)).nonzero()[:, 0]
            x = padded[neighbor_idx[rows, tap].long()]
            parts[s, tap] = x.T @ grad_out[rows].to(acc)
    return parts.sum(0)


def pyramid(capacity_div, exactness="cond", n=4096, seed=0):
    point = synthetic_point_batch(n, 2, depth=10, seed=seed, device="cpu")
    caps = [pyr.round_up(max(n // d, 8), 8) for d in capacity_div]
    return pyr.build_pyramid(point, strides=(2,) * 4, capacities=caps, orders=("z",),
                             stem_kernel=5, exactness=exactness)


# SpUNet's capacities (no level overflows), then capacities small enough that
# every pooled level overflows, through the sorted builds ("cond") and the
# parity chain forced
@pytest.mark.parametrize("capacity_div,exactness", [
    ((2, 4, 16, 64), "cond"), ((8, 64, 256, 512), "cond"), ((8, 64, 256, 512), "parity")])
def test_every_pyramid_table_is_symmetric(capacity_div, exactness):
    levels, stem = pyramid(capacity_div, exactness)
    drops = [lv.dropped for lv in levels[1:]]
    assert (sum(drops) == 0) == (capacity_div == (2, 4, 16, 64))
    for lv in levels:
        nbr = lv.point.neighbor_idx
        assert nbr.shape[1] == 27 and nbr.dtype == torch.int32
        assert asymmetric_entries(nbr) == 0
        # padding rows read nothing and nothing reads them
        pad = ~lv.point.mask
        assert (nbr[pad] == nbr.shape[0]).all()
        assert not torch.isin(nbr[~pad], torch.nonzero(pad)[:, 0].int()).any()
    assert stem.shape[1] == 125 and asymmetric_entries(stem) == 0


def test_an_asymmetric_table_is_detected():
    nbr = torch.full((3, 3), 3, dtype=torch.int32)
    nbr[0, 0] = 1  # row 0 reads row 1 at tap 0, but row 1 does not read 0 at tap 2
    assert asymmetric_entries(nbr) == 1
    nbr[1, 2] = 0
    assert asymmetric_entries(nbr) == 0


def conv_case(k, c_in, c_out, seed):
    """A table of level 0 (k3 or the k5 stem) of a 2-scene bucket with
    padding rows and missing neighbors, float64 features and weights."""
    levels, stem = pyramid((2, 4, 16, 64), n=2048, seed=seed)
    nbr = stem if k == 125 else levels[0].point.neighbor_idx
    mask = levels[0].point.mask
    n = nbr.shape[0]
    assert (~mask).any() and ((nbr == n) & mask[:, None]).any()
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn((n, c_in), generator=g, dtype=torch.float64)
    weight = torch.randn((k, c_in, c_out), generator=g, dtype=torch.float64)
    bias = torch.randn((c_out,), generator=g, dtype=torch.float64)
    grad = torch.randn((n, c_out), generator=g, dtype=torch.float64)
    return nbr, mask, feat, weight, bias, grad


def gather_form(feat, nbr, weight, bias):
    """`subm_conv_apply`'s plain form with autograd's own backward of the
    gather, which sums in float64 (the port's `gather_rows` sums in
    float32)."""
    n, c_in = feat.shape
    rows = torch.cat([feat, feat.new_zeros((1, c_in))])[nbr.long()]
    return rows.reshape(n, -1) @ weight.reshape(-1, weight.shape[2]) + bias


@pytest.mark.parametrize("k,c_in,c_out", [(27, 32, 32), (27, 6, 32), (125, 6, 32),
                                          (125, 32, 16)])
def test_plain_gradients_equal_autograd_of_the_gather_form(k, c_in, c_out):
    nbr, mask, feat, weight, bias, grad = conv_case(k, c_in, c_out, seed=k + c_in)
    leaves = [t.clone().requires_grad_(True) for t in (feat, weight, bias)]
    out = gather_form(leaves[0], nbr, leaves[1], leaves[2])
    assert torch.equal(out.detach(), subm_conv_apply(feat, nbr, weight, bias))
    # a padding row reads no neighbor: its output is the bias
    assert torch.equal(out[~mask].detach(), bias.expand(int((~mask).sum()), c_out))
    d_feat, d_weight, d_bias = torch.autograd.grad(out, leaves, grad)

    reflected = subm_conv_apply(grad, nbr, reflected_weight(weight))
    assert reflected.shape == feat.shape
    assert torch.allclose(reflected, d_feat, rtol=1e-12, atol=1e-12)
    assert (reflected[~mask] == 0).all()
    for splits in (1, 3):
        tiled = weight_grad_plain(feat, nbr, grad, splits=splits)
        assert tiled.dtype == torch.float64
        assert torch.allclose(tiled, d_weight, rtol=1e-12, atol=1e-12)
    assert torch.allclose(grad.sum(0), d_bias, rtol=1e-12, atol=1e-12)


def test_tile_tap_share_on_a_hand_built_table():
    n = 5
    nbr = torch.full((n, 3), n, dtype=torch.int32)
    nbr[0, 1] = 0  # tile 0 (rows 0-1): tap 1
    nbr[1, 2] = 3  # tile 0: tap 2
    nbr[4, 0] = 2  # tile 2 (row 4 and one row past n): tap 0
    want = torch.tensor([[False, True, True], [False, False, False],
                         [True, False, False]])
    assert torch.equal(tile_taps(nbr, block_rows=2), want)
    assert tile_tap_share(nbr, block_rows=2) == pytest.approx(3 / 9)
    assert tile_tap_share(nbr, block_rows=8) == pytest.approx(3 / 3)
    assert tile_tap_share(torch.full((4, 27), 4, dtype=torch.int32)) == 0.0


def test_dual_conv_equals_two_convs():
    nbr, _, feat, weight, _, _ = conv_case(27, 6, 32, seed=1)
    fb, wb = feat[:, :4].flip(1).contiguous(), weight[:, :4, :8]
    got_a, got_b = dual_subm_conv_apply(feat, fb, nbr, weight, wb)
    assert torch.allclose(got_a, subm_conv_apply(feat, nbr, weight), rtol=1e-12, atol=1e-12)
    assert torch.allclose(got_b, subm_conv_apply(fb, nbr, wb), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bad,error", [("dtype", TypeError), ("channels", ValueError),
                                       ("table_dtype", TypeError), ("taps", ValueError),
                                       ("stride", ValueError)])
def test_kernel_inputs_are_checked(bad, error):
    x = torch.zeros((64, 32))
    nbr = torch.full((64, 27), 64, dtype=torch.int32)
    c_in = 32
    if bad == "dtype":
        x = x.half()
    elif bad == "channels":
        c_in = 16
    elif bad == "table_dtype":
        nbr = nbr.long()
    elif bad == "taps":
        nbr = torch.full((64, 129), 64, dtype=torch.int32)
    else:
        x = torch.zeros((32, 64)).T
    with pytest.raises(error):
        _check(x, nbr, c_in, "test")


def test_other_devices_are_refused():
    nbr = torch.full((4, 27), 4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        subm_conv_apply(torch.zeros((4, 8), device="meta"), nbr, torch.zeros((27, 8, 8)))


TINY_PTV3 = dict(
    type="PT-v3m1", c_in_channels=6, n_in_channels=6,
    order=("z", "z-trans", "hilbert", "hilbert-trans"), c_stride=(4, 4),
    c_enc_depths=(1, 1, 1), c_enc_channels=(8, 16, 16), c_enc_num_head=(1, 2, 2),
    c_enc_patch_size=(64, 64, 64), c_dec_depths=(1, 1), c_dec_channels=(8, 8),
    c_dec_num_head=(1, 1), c_dec_patch_size=(64, 64), n_stride=(2, 2, 2, 2),
    n_enc_depths=(1, 1, 1, 1, 1), n_enc_channels=(8, 16, 16, 16, 16),
    n_enc_num_head=(1, 2, 2, 2, 2), n_enc_patch_size=(64, 64, 64, 64, 64),
    n_dec_depths=(1, 1, 1, 1), n_dec_channels=(8, 8, 16, 16), n_dec_num_head=(1, 1, 2, 2),
    n_dec_patch_size=(64, 64, 64, 64), mlp_ratio=2, drop_path=0.0, num_classes=5, T_dim=16,
    condition=True, skip_connection_mode="cat", skip_connection_scale=True)


def tiny_cdsegnet(modes, capacity_div):
    return dict(
        type="DefaultSegmentorV2",
        backbone=dict(TINY_PTV3, capacity_div=capacity_div, **modes),
        criteria=[dict(type="MSELoss", loss_weight=1.0)], loss_type="GLS", task_num=2,
        num_classes=5, T=20, beta_start=0, beta_end=1000, noise_schedule="cosine",
        T_dim=16, dm=True, dm_input="xt", dm_target="noise", condition=True,
        c_in_channels=6)


def ssi_and_gradients(model, point):
    """SSI logits, then the gradients of one training forward's outputs
    (every draw fed in), by parameter name."""
    g = torch.Generator().manual_seed(3)
    noise = torch.randn(point.feat.shape, generator=g)
    model.eval()
    logits = model.inference(point, noise=noise)["seg_logits"]
    model.train()
    out = model(point, ts_scene=torch.tensor([4, 11]), noise=noise,
                mse_valid=point.mask)
    mask = point.mask[:, None]
    loss = (out["n_pred"] * mask).square().sum() + (out["c_pred"] * mask).square().sum()
    model.zero_grad()
    loss.backward()
    return logits, {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("capacity_div,dropped", [
    ((1, 2, 4, 8, 8), False), ((1, 16, 64, 256, 256), True)], ids=["fit", "overflow"])
def test_cond_stem_and_xcpe_compute_the_gather(monkeypatch, capacity_div, dropped):
    """``stem_mode`` and ``xcpe_mode`` "cond" give the SSI logits and first
    gradients of "gather" with the same weights, bit for bit, on a batch
    whose pooled levels keep every point and on one where they drop
    points; no blocked form runs in either."""
    point = synthetic_point_batch(2048, 2, depth=7, seed=1, device="cpu")
    gather = build_model(tiny_cdsegnet(dict(stem_mode="gather", xcpe_mode="gather"),
                                       capacity_div),
                         device="cpu", generator=torch.Generator().manual_seed(0))
    cond = build_model(tiny_cdsegnet(dict(stem_mode="cond", xcpe_mode="cond"), capacity_div),
                       device="cpu", generator=torch.Generator().manual_seed(1))
    cond.load_state_dict(gather.state_dict())
    levels, _ = cond.backbone.precompute_geometry(point)
    assert levels[1].parent_inverse is not None  # the blocked forms had their operands
    assert (sum(lv.dropped for lv in levels[1:]) > 0) == dropped

    def refuse(*args, **kwargs):
        raise AssertionError("a blocked form ran")

    monkeypatch.setattr(ptv3, "blocked_stem_apply", refuse)
    monkeypatch.setattr(modules, "blocked_k3_conv_apply", refuse)
    monkeypatch.setattr(modules, "blocked_subm_conv_apply", refuse)
    want_logits, want_grads = ssi_and_gradients(gather, point)
    got_logits, got_grads = ssi_and_gradients(cond, point)
    assert torch.equal(got_logits, want_logits)
    assert got_grads.keys() == want_grads.keys()
    assert "backbone.dual_embedding.n_weight" in got_grads
    for name, grad in want_grads.items():
        assert torch.equal(got_grads[name], grad), name
