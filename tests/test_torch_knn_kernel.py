"""The fused kNN kernel (`cdsegnet_torch/csrc/knn.cu`) behind `pointops.knn`.

On the GPU the kernel's route must equal `knn_dense` bit for bit: indices
equal and distances `torch.equal`, over one and several scenes, invalid
queries and references, scenes smaller than k, duplicated points and
integer lattices (where many distances tie and the lower index must win),
and two different clouds. On the CPU: the wrapper's contract (a CPU tensor
takes the plain route and launches nothing), the list length the kernel
takes for each k, and the refusal of k above 64 before any launch.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
machine without them: ``python -m pytest --noconftest tests/test_torch_knn_kernel.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from cdsegnet_torch.ops import pointops as po  # noqa: E402
from cdsegnet_torch.utils import tracing  # noqa: E402

torch.set_num_threads(2)


def cloud(kind, n, seed=0):
    """``(coord, mask, batch)`` numpy arrays for a layout: ``"one"`` a single
    random scene, all valid; ``"scenes"`` three scenes of unequal size, a
    fourth of 2 valid points, invalid points scattered and padding at the
    tail; ``"lattice"`` integer coordinates on a small grid, each site
    repeated, two scenes (most distances tie); ``"radial"`` three scenes of
    room-like surfaces sorted by distance from a centre, as a sphere crop
    leaves them (many tiles a scene, the scan's wrap)."""
    rng = np.random.RandomState(seed)
    if kind == "one":
        return (rng.rand(n, 3) * 4).astype(np.float32), np.ones(n, bool), np.zeros(n, np.int32)
    if kind == "lattice":
        side = int(round((n / 2) ** (1 / 3))) + 1
        sites = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
        coord = np.repeat(sites, 2, 0)[:n].astype(np.float32)
        rng.shuffle(coord)
        batch = (np.arange(n) >= n // 3).astype(np.int32)
        return coord, rng.rand(n) > 0.1, batch
    if kind == "radial":
        parts = []
        for s, m in enumerate((n // 2, n // 3, n - n // 2 - n // 3)):
            uv = rng.rand(m, 2) * 3
            face = rng.randint(0, 3, m)
            p = np.zeros((m, 3))
            for a in range(3):  # three walls: x = 0, y = 0, z = 0
                on = face == a
                p[on] = np.insert(uv[on], a, 0.0, 1)
            p = p[np.argsort(((p - p[rng.randint(m)]) ** 2).sum(1), kind="stable")]
            parts.append((p.astype(np.float32), np.full(m, s, np.int32)))
        coord = np.concatenate([p for p, _ in parts])
        return coord, np.ones(n, bool), np.concatenate([b for _, b in parts])
    assert kind == "scenes"
    coord = (rng.rand(n, 3) * np.array([2.0, 1.5, 1.0])).astype(np.float32)
    coord[n // 5:n // 5 + 40] = coord[n // 10:n // 10 + 40]  # a copied run
    coord[n // 2:n // 2 + 12] = coord[n // 2]  # one point repeated
    batch = np.sort(rng.choice(3, n, p=[0.5, 0.3, 0.2])).astype(np.int32)
    mask = rng.rand(n) > 0.15
    batch[n - 42:n - 40], mask[n - 42:n - 40] = 3, True
    batch[n - 40:], mask[n - 40:] = 4, False
    return coord, mask, batch


def as_kwargs(mask, batch, device, ids=True):
    """Masks and scene ids for a search of a cloud against itself: the same
    tensors on both sides, as PTv2's tables pass them."""
    m = torch.from_numpy(mask).to(device)
    b = torch.from_numpy(batch).to(device) if ids else None
    return dict(query_mask=m, ref_mask=m, query_batch=b, ref_batch=b)


# ---------------------------------------------------------------------------
# the contract, without a card


def test_the_list_length_for_every_k():
    got = {k: po.knn_slots(k) for k in range(1, 65)}
    assert got == {k: min(s for s in (1, 4, 8, 16, 32, 64) if s >= k) for k in range(1, 65)}
    assert set(got.values()) == set(po.SLOTS)


@pytest.mark.parametrize("k", [0, 65, 128])
def test_k_outside_the_kernels_range_is_refused_before_a_launch(k):
    coord = torch.zeros((8, 3))
    order = torch.arange(8)
    before = po.knn_fused.launches
    # the wrapper checks k first: these CPU tensors never reach a device
    with pytest.raises(ValueError, match="1 to 64 neighbours"):
        po.knn_fused(coord, coord, k, order, order, [(0, 8, 0, 8)], 8)
    assert po.knn_fused.launches == before


def test_the_kernel_wrapper_refuses_a_cpu_tensor():
    coord = torch.zeros((8, 3))
    with pytest.raises(ValueError, match="CUDA tensors"):
        po.knn_fused(coord, coord, 4, torch.arange(8), torch.arange(8), [(0, 8, 0, 8)], 8)


@pytest.mark.parametrize("kind,k,ids", [("scenes", 16, True), ("scenes", 3, False),
                                        ("lattice", 8, True), ("one", 70, False)])
def test_a_cpu_tensor_takes_the_plain_route(kind, k, ids):
    """The CPU route is the tiles and `k_smallest`, any k, no launch; a
    search of a cloud against itself equals the search against a copy of
    it, and both equal the dense plain version."""
    coord, mask, batch = cloud(kind, 500, seed=1)
    kw = as_kwargs(mask, batch, "cpu", ids)
    c = torch.from_numpy(coord)
    before = po.knn_fused.launches
    with tracing.capture() as cap:
        si, sd = po.knn(c, c, k, **kw)
    kw2 = dict(kw, ref_mask=kw["ref_mask"].clone(),
               ref_batch=None if kw["ref_batch"] is None else kw["ref_batch"].clone())
    ci, cd = po.knn(c, c.clone(), k, **kw2)
    di, dd = po.knn_dense(c, c, k, chunk=128, **kw)
    assert po.knn_fused.launches == before and cap.launches["knn"] == 0
    assert si.dtype == torch.int32 and tuple(si.shape) == (500, k)
    for i, d in ((ci, cd), (di, dd)):
        assert torch.equal(si, i) and torch.equal(sd, d)
    # the counters: valid queries, and the pairs of each scene
    keys = np.where(mask, batch if ids else 0, -1)
    sizes = [int((keys == s).sum()) for s in np.unique(keys[keys >= 0])]
    assert cap.counters["knn.queries"] == sum(sizes)
    assert cap.counters["knn.pairs"] == sum(s * s for s in sizes)


# ---------------------------------------------------------------------------
# the kernel, on the card


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def equal_to_dense(query, ref, k, launches=1, **kw):
    """Run the kernel's route and the dense plain version; assert the
    launches (one a call of up to 64 scenes), indices equal and distances
    equal to the bit."""
    before = po.knn_fused.launches
    ci, cd = po.knn(query, ref, k, **kw)
    torch.cuda.synchronize()
    assert po.knn_fused.launches == before + launches
    di, dd = po.knn_dense(query, ref, k, chunk=512, **kw)
    assert ci.dtype == torch.int32 and tuple(ci.shape) == (query.shape[0], k)
    bad = int((ci != di).any(1).sum())
    assert bad == 0, f"{bad} rows differ"
    assert torch.equal(cd, dd)
    return ci, cd


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 8, 16, 32])
@pytest.mark.parametrize("kind,n", [("one", 3000), ("scenes", 5000), ("lattice", 4000),
                                    ("radial", 12000)])
def test_the_kernel_equals_the_dense_plain_version(cuda_device, kind, n, k):
    coord, mask, batch = cloud(kind, n, seed=k)
    c = torch.from_numpy(coord).to(cuda_device)
    kw = as_kwargs(mask, batch, cuda_device, ids=kind != "one")
    ci, cd = equal_to_dense(c, c, k, **kw)
    if kind == "scenes":  # invalid queries: N and BIG; the 2-point scene fills 2 slots
        m = torch.from_numpy(mask).to(cuda_device)
        assert (ci[~m] == n).all() and (cd[~m] == po.BIG).all()
        tail = ci[n - 42:n - 40]
        assert (tail[:, :min(k, 2)] < n).all() and (tail[:, 2:] == n).all()


@pytest.mark.cuda
def test_ties_go_to_the_lower_index_on_the_card(cuda_device):
    """Eight copies of one point around a query at the same distance: the k
    nearest are the lowest indices, in index order."""
    rng = np.random.RandomState(5)
    ref = rng.rand(40, 3).astype(np.float32) + 5.0
    ref[[3, 7, 11, 19, 23, 29, 31, 37]] = 0.5
    query = np.full((2, 3), 0.5, np.float32)
    ti, td = po.knn(torch.from_numpy(query).to(cuda_device),
                    torch.from_numpy(ref).to(cuda_device), 5)
    assert ti[0].tolist() == [3, 7, 11, 19, 23] and (td == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k,ids", [(1, False), (1, True), (3, True)])
def test_two_clouds_on_the_card(cuda_device, k, ids):
    """Queries that are not the references: MSC's 1-NN match (no scene ids)
    and the evaluator's remap (k = 1), `three_interpolation` (k = 3)."""
    coord, mask, batch = cloud("scenes", 6000, seed=7)
    rng = np.random.RandomState(8)
    q = coord[::2] + rng.rand(3000, 3).astype(np.float32) * 0.01
    t = lambda x: torch.from_numpy(x).to(cuda_device)  # noqa: E731
    kw = dict(query_mask=t(mask[::2]), ref_mask=t(mask))
    if ids:
        kw.update(query_batch=t(batch[::2]), ref_batch=t(batch))
    equal_to_dense(t(q), t(coord), k, **kw)


@pytest.mark.cuda
def test_more_than_64_scenes_launch_once_for_each_64(cuda_device):
    """A call over 130 scenes launches three times (64 + 64 + 2 scenes),
    and the counter says so."""
    rng = np.random.RandomState(11)
    n = 130 * 20
    coord = (rng.rand(n, 3) * 2).astype(np.float32)
    batch = np.repeat(np.arange(130), 20).astype(np.int32)
    c = torch.from_numpy(coord).to(cuda_device)
    kw = as_kwargs(rng.rand(n) > 0.1, batch, cuda_device)
    equal_to_dense(c, c, 8, launches=3, **kw)


@pytest.mark.cuda
def test_a_k_above_64_is_refused_on_the_card(cuda_device):
    c = torch.rand((100, 3), device=cuda_device)
    before = po.knn_fused.launches
    with pytest.raises(ValueError, match="1 to 64 neighbours"):
        po.knn(c, c, 65)
    assert po.knn_fused.launches == before


@pytest.mark.cuda
def test_a_traced_call_launches_once_and_reads_only_the_runs(cuda_device):
    """A self search under a capture: one `knn` launch, and the host reads
    only the scene runs (for the queries and for the references, each the
    size of its `unique_consecutive` and one read of its values and
    counts), the same counters as the plain route."""
    coord, mask, batch = cloud("scenes", 5000, seed=3)
    c = torch.from_numpy(coord).to(cuda_device)
    kw = as_kwargs(mask, batch, cuda_device)
    po.knn(c, c, 16, **kw)  # warm: the build and the first launch
    torch.cuda.synchronize()
    with tracing.capture() as cap:
        po.knn(c, c, 16, **kw)
    torch.cuda.synchronize()
    assert cap.launches["knn"] == 1
    assert cap.counters.get(tracing.SYNCS, 0) <= 4, cap.counted_by_span(tracing.SYNCS)
    with tracing.capture() as plain:
        po.knn(c.cpu(), c.cpu(), 16, **{k: v.cpu() for k, v in kw.items()})
    assert {k: cap.counters[k] for k in ("knn.queries", "knn.pairs")} == \
        {k: plain.counters[k] for k in ("knn.queries", "knn.pairs")}
