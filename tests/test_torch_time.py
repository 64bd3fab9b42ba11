"""The timing protocol in the port against the JAX package: the tester under
`configs/scannet/cdsegnet_time.py` (a 0.1 mm test grid) on a synthetic room
of 16,409 points. As shipped, its ``aug_transform=[]`` gives the test
dataset no pass at all: no fragment, no forward, and every point predicted
class 0, in both packages. With one identity pass (``aug_transform=[[]]``)
the room is one whole-scene fragment, whose grid coordinates reach 44,000:
at serialization depth 12 as shipped (the curve
codes keep 12 bits of each axis and wrap; neighbors beyond 4,095 count as
missing) and at depth 16 (which covers them, and whose (key, index) sorts
of the 32,768-slot bucket need 64 bits: the pyramid leaves its packed
sorts). Probabilities and records against JAX's `SemSegTester` with JAX's
noise fed in, on the tiny model. Also `tools/test_time.py` on the CPU."""

import copy
import os
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import optax  # noqa: E402

from cdsegnet_tpu.engine.config import Config as JConfig  # noqa: E402
from cdsegnet_tpu.engine.state import TrainState  # noqa: E402
from cdsegnet_tpu.engine.test import SemSegTester as JTester  # noqa: E402
from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_torch.engine.config import Config  # noqa: E402
from cdsegnet_torch.engine.test import SemSegTester  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.tools import test_time  # noqa: E402
from cdsegnet_torch.utils.synthetic import room_scene  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_model import TINY_MODEL  # noqa: E402
from test_torch_model import as_numpy, batches, random_variables  # noqa: E402

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "configs", "scannet", "cdsegnet_time.py")
TINY = os.path.join(REPO, "configs", "_smoke_", "cdsegnet_tiny.py")
DEPTHS = (12, 16)


def tiny20():
    """The tiny model with ScanNet's 20 classes."""
    cfg = copy.deepcopy(TINY_MODEL)
    cfg["num_classes"] = cfg["backbone"]["num_classes"] = 20
    return cfg


def time_cfg(root, save, depth, passes=([],)):
    """The timing config on the tiny model; ``passes`` replaces its
    ``aug_transform`` (``None`` keeps the shipped ``[]``)."""
    cfg = Config.fromfile(CONFIG)
    cfg.merge_from_dict(dict(save_path=save, num_devices=1, serialization_depth=depth))
    cfg["model"] = tiny20()
    cfg.data.test["data_root"] = root
    if passes is not None:
        cfg.data.test.test_cfg["aug_transform"] = [list(p) for p in passes]
    return cfg


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """JAX's tester at each depth: the fragment, its noise, probabilities
    and records, and whether the packed sorts fell back."""
    tmp = tmp_path_factory.mktemp("time")
    root = str(tmp / "data")
    os.makedirs(os.path.join(root, "val"))
    torch.save(room_scene(0, cell=0.08), os.path.join(root, "val", "scene0000_00.pth"))
    model = jbuild(tiny20())
    variables = random_variables(model, batches()["fit"])
    state = TrainState.create(variables, optax.identity(), jax.random.PRNGKey(0))
    out = dict(root=root, variables=as_numpy(variables))
    for depth in DEPTHS + ("shipped",):
        save = str(tmp / f"jax{depth}")
        cfg = JConfig(JConfig._wrap(dict(
            time_cfg(root, save, 12, passes=None) if depth == "shipped"
            else time_cfg(root, save, depth))))
        tester = JTester(cfg, state=state, model=model, verbose=False)
        frags, noise, probs = [], [], []
        prepare, predict = tester._prepare_fragment, tester.predict_fragment

        def record_noise(frag, rng, prepare=prepare, noise=noise, frags=frags):
            out_ = prepare(frag, rng)
            frags.append(frag)
            noise.append(np.asarray(out_[3]))
            return out_

        def record_probs(frag, rng, predict=predict, probs=probs):
            p = predict(frag, rng)
            probs.append(np.asarray(p))
            return p

        tester._prepare_fragment = record_noise
        tester.predict_fragment = record_probs
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            miou = tester.test()
        out[depth] = dict(frags=frags, noise=noise, probs=probs, miou=miou,
                          records=tester.records,
                          fallback=any("packed" in str(w.message) for w in caught))
    return out


@pytest.mark.parametrize("depth", DEPTHS)
def test_whole_scene_fragment_matches_jax(jref, depth, tmp_path):
    ref = jref[depth]
    model = tbuild(tiny20(), device="cpu")
    load_jax_variables(model, jref["variables"])
    tester = SemSegTester(time_cfg(jref["root"], str(tmp_path), depth), model=model,
                          device="cpu", verbose=False)
    frags, probs = [], []
    predict = tester.predict_fragment

    def record(frag, index, noise_fn=None, feat_noise_fn=None):
        frags.append(frag)
        p = predict(frag, index, noise_fn, feat_noise_fn)
        probs.append(p.numpy())
        return p

    tester.predict_fragment = record
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        miou = tester.test(noise_fn=lambda i, bucket, c_in: np.array(ref["noise"][i]))
    fallback = any("packed sort" in str(w.message) for w in caught)
    # one fragment: every raw point, grid coordinates past 4,095
    assert len(frags) == len(ref["frags"]) == 1
    frag = frags[0]
    assert len(frag["coord"]) == 16409 and ref["noise"][0].shape == (32768, 6)
    assert frag["grid_coord"].max() > 40000
    for k in ("coord", "grid_coord", "index", "feat"):
        np.testing.assert_array_equal(frag[k], ref["frags"][0][k])
    # depth 16 leaves the packed sorts in both packages, depth 12 keeps them
    assert fallback == ref["fallback"] == (depth == 16)
    assert np.abs(probs[0] - ref["probs"][0]).max() <= 1e-4
    for k in ("intersection", "union", "target"):
        np.testing.assert_array_equal(tester.records["scene0000_00"][k],
                                      ref["records"]["scene0000_00"][k])
    assert miou == pytest.approx(ref["miou"], abs=0)


def test_shipped_time_config_runs_no_fragment(jref, tmp_path):
    """``aug_transform=[]``: no pass, no fragment and no forward in either
    package; every raw point takes class 0 (votes all zero), the same
    records."""
    ref = jref["shipped"]
    assert ref["frags"] == [] and ref["probs"] == []
    model = tbuild(tiny20(), device="cpu")
    tester = SemSegTester(time_cfg(jref["root"], str(tmp_path), 12, passes=None),
                          model=model, device="cpu", verbose=False)
    tester.forward_fragment = lambda *a: pytest.fail("no fragment, no forward")
    miou = tester.test()
    pred = np.load(os.path.join(str(tmp_path), "result", "scene0000_00_pred.npy"))
    assert pred.shape == (16409,) and (pred == 0).all()
    for k in ("intersection", "union", "target"):
        np.testing.assert_array_equal(tester.records["scene0000_00"][k],
                                      ref["records"]["scene0000_00"][k])
    assert miou == pytest.approx(ref["miou"], abs=0)


def test_depths_differ_on_the_wrapped_grid(jref):
    """Depth 12 wraps the 0.1 mm grid, depth 16 does not: the two give other
    probabilities on the same fragment and noise."""
    a, b = jref[12]["probs"][0], jref[16]["probs"][0]
    np.testing.assert_array_equal(jref[12]["noise"][0], jref[16]["noise"][0])
    assert np.abs(a - b).max() > 1e-3


def test_test_time_tool_runs_on_the_cpu(capsys, monkeypatch):
    """The JAX tool's scene (uniform voxels of a 512^3 grid from
    RandomState(0)) through SSI, timed, on the tiny config."""
    got = test_time.main(["--config-file", TINY, "--num-points", "2048", "--iters", "2",
                          "--device", "cpu"])
    assert got["ms_per_scene"] > 0 and got["points_per_s"] > 0
    assert "SSI latency:" in capsys.readouterr().out
    scene = test_time.timing_scene(2048, 6)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(scene["grid_coord"], rng.randint(0, 512, (2048, 3)))
    np.testing.assert_array_equal(scene["feat"], rng.randn(2048, 6).astype(np.float32))
    np.testing.assert_array_equal(scene["coord"], (scene["grid_coord"] * 0.02).astype(np.float32))
    assert scene["mask"].all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_time.main(["--config-file", TINY, "--num-points", "2048"])
