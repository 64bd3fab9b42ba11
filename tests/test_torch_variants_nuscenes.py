"""The nuScenes configurations of the CDSegNet family in the port against
the JAX package: CDSegNet, PTv3+CNF, the Baseline and plain PTv3 on
scattered voxels that overflow the pooled levels, as outdoor sweeps do.
The same checks as `tests/test_torch_variants.py` (SSI logits, and one
training step with every draw injected against `jax.grad`), over its
helpers and seeds, with this file's own JAX references."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_variants import (VARIANTS, check_ssi, check_train_step,  # noqa: E402
                                 jax_references)

torch.set_num_threads(2)
NUSCENES = [n for n in VARIANTS if n.startswith("nuscenes/")]


@pytest.fixture(scope="module")
def jref():
    return jax_references(NUSCENES)


@pytest.mark.parametrize("name", NUSCENES)
def test_variant_ssi_matches_jax(jref, name):
    check_ssi(jref[name], name)


@pytest.mark.parametrize("name", NUSCENES)
def test_variant_train_step_matches_jax(jref, name):
    check_train_step(jref[name], name)
