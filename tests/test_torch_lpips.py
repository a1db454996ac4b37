"""The port's LPIPS (``moco_flow_tpu_torch/nn/lpips.py``) against the JAX
package's, and its place in ``evaluate_sequence``.

On JAX's ``random_weights`` the two distances agree within 1e-5 relative
(measured ~1e-7: fp32 convolutions in other orders). The port's
``random_weights`` has JAX's shapes; weights load from the same ``.npz``
through ``$LPIPS_WEIGHTS_NPZ``, and with them ``evaluate_sequence`` (and
``test.py --eval_metrics``) adds ``lpips``, as JAX's does.
"""

import numpy as np
import pytest
import torch

import jax

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.nn import lpips as jax_lpips
from moco_flow_tpu_torch.data.synthetic import make_synthetic_scene
from moco_flow_tpu_torch.nn import lpips
from moco_flow_tpu_torch.test import parse_args, test as run_test
from scripts.make_torch_port_train_golden import SCENE, train_config


@pytest.fixture(scope="module")
def weights():
    return jax_lpips.random_weights(jax.random.key(0))


@pytest.mark.parametrize("shape,seed", [((2, 3, 64, 64), 0),
                                        ((1, 3, 48, 80), 1)])
def test_lpips_equals_jax(weights, shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    b = np.clip(a + rng.normal(scale=0.1, size=shape), 0, 1).astype(
        np.float32)
    want = np.asarray(jax_lpips.lpips(weights, a, b))
    got = lpips.lpips(weights, torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (shape[0],) and (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    same = lpips.lpips(weights, torch.from_numpy(a), torch.from_numpy(a))
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-7)


def test_random_weights_have_jax_shapes(weights):
    mine = lpips.random_weights(3)
    assert {k: v.shape for k, v in mine.items()} == \
        {k: v.shape for k, v in weights.items()}
    assert all(v.dtype == np.float32 for v in mine.values())


def test_weights_load_from_the_env(tmp_path, monkeypatch, weights):
    monkeypatch.delenv("LPIPS_WEIGHTS_NPZ", raising=False)
    assert not lpips.available() and lpips.available(weights)
    with pytest.raises(FileNotFoundError, match="LPIPS_WEIGHTS_NPZ"):
        lpips.load_weights()
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **weights)
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", path)
    assert lpips.available()
    got = lpips.load_weights()
    assert set(got) == set(weights)
    for k in got:
        np.testing.assert_array_equal(got[k], weights[k])


def test_eval_metrics_adds_lpips_with_weights(tmp_path, monkeypatch,
                                              weights):
    scene = make_synthetic_scene(None, **SCENE)
    args = parse_args(["-c", "unused", "--render_gt", "--reso", "32",
                       "--eval_metrics", "--eval_max_frames", "1",
                       "--device", "cpu"])
    monkeypatch.delenv("LPIPS_WEIGHTS_NPZ", raising=False)
    tr = run_test(train_config(None, str(tmp_path / "log")), args,
                  scene=scene)
    assert "lpips" not in tr.metrics
    path = str(tmp_path / "lpips.npz")
    np.savez(path, **weights)
    monkeypatch.setenv("LPIPS_WEIGHTS_NPZ", path)
    tr = run_test(train_config(None, str(tmp_path / "log")), args,
                  scene=scene)
    assert tr.metrics["frames"] == 1 and np.isfinite(tr.metrics["lpips"])
    assert tr.metrics["lpips"] > 0
