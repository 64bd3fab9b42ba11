"""Each option of the PTv3 surface that the port once refused, in the
port against the JAX package: the tiny flagship-shaped model of
`tests/test_torch_model.py` with the option set builds and gives JAX's SSI
logits (`tests/test_torch_options.py` holds each module, and
`tests/test_torch_option_models.py` whole models with a training step)."""

from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from cdsegnet_tpu.models.builder import build_model as jbuild  # noqa: E402
from cdsegnet_tpu.models.segmentor import CNFSegmentor as JCNF  # noqa: E402
from cdsegnet_torch.models.builder import build_model as tbuild  # noqa: E402
from cdsegnet_torch.utils.weights import load_jax_variables  # noqa: E402
from test_torch_model import N, as_numpy, batches, random_variables, tiny_cfg, to_port  # noqa: E402

torch.set_num_threads(2)


OPTIONS = [("xcpe_mode", "cond"), ("enable_rpe", True), ("tm_restomer", True),
           ("tm_bidirectional", True), ("tm_feat", "channel_scale"),
           ("b_factor", (1.2, 1.0, 1.0, 1.0))]


def _option_ssi(case):
    field, value = case
    jm = jbuild(tiny_cfg(**{field: value}))
    pt = batches()["fit"]
    noise = np.random.RandomState(2).randn(N, 6).astype(np.float32)
    variables = as_numpy(random_variables(jm, pt))
    logits = jax.jit(lambda v: jm.apply(v, pt, noise, method=JCNF.inference)[
        "seg_logits"])(variables)
    return variables, noise, np.asarray(logits)


@pytest.fixture(scope="module")
def option_ref():
    """JAX SSI of the tiny model with each option of `OPTIONS`, compiled on
    parallel threads (this file runs late in the suite, where cores are
    free)."""
    with ThreadPoolExecutor(len(OPTIONS)) as ex:
        return dict(zip(OPTIONS, ex.map(_option_ssi, OPTIONS)))


@pytest.mark.parametrize("field,value", OPTIONS)
def test_option_paths_match_jax(option_ref, field, value):
    """Each option of the PTv3 surface that the port once refused builds
    and gives JAX's SSI logits."""
    variables, noise, want = option_ref[(field, value)]
    m = tbuild(tiny_cfg(**{field: value}), device="cpu")
    load_jax_variables(m, variables)
    pt = batches()["fit"]
    got = m.inference(to_port(pt), noise=torch.from_numpy(noise))["seg_logits"].numpy()
    valid = np.asarray(pt.mask)
    err = np.abs(got - want)[valid].max()
    assert err <= 1e-5 * np.abs(want[valid]).max() + 1e-6
