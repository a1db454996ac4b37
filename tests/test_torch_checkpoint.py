"""Checkpoints cross between the packages: a JAX ``save_checkpoint`` file
loads into the port and renders what JAX rendered (the golden fixture's
fp32 case, tolerance 1e-5 as in test_torch_nn.py), and a file the port
writes reads back in JAX ``load_checkpoint`` and ``merge_into`` unchanged.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.train import checkpoint as jck
from moco_flow_tpu.train.factory import build_statics as j_statics
from moco_flow_tpu.train.factory import init_params as j_init
from moco_flow_tpu_torch.render.volume import RenderConfig, render_rays
from moco_flow_tpu_torch.train import checkpoint as tck
from moco_flow_tpu_torch.train.factory import build_statics, init_params
from scripts.make_torch_port_golden import CASES, FIXTURE, MODEL_CFG


@pytest.fixture(scope="module")
def golden():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def _leaves(tree):
    return {k: np.asarray(v) for k, v in jck._flatten(tree).items()}


def test_jax_checkpoint_renders_in_port(golden, tmp_path):
    tree = jck._unflatten({k[len("params/"):]: jnp.asarray(v)
                           for k, v in golden.items()
                           if k.startswith("params/")})
    path = str(tmp_path / "ckpts" / "epoch1_iter42")
    jck.save_checkpoint(path, {"params": tree},
                        extra={"clock": {"epoch": 1, "minibatch": 0,
                                         "step": 42}})
    loaded, extra = tck.load_checkpoint(path + ".npz")
    assert extra["clock"]["step"] == 42 and tck.ckpt_step(path) == 42
    params = tck.merge_into(
        init_params(torch.Generator().manual_seed(0),
                    build_statics(MODEL_CFG), with_nof=True),
        loaded["params"], strict=True)
    anneal = {k[len("anneal/"):]: torch.from_numpy(v)
              for k, v in golden.items() if k.startswith("anneal/")}
    rcfg = RenderConfig(n_samples=MODEL_CFG["N_samples"],
                        n_importance=MODEL_CFG["N_importance"],
                        test_time=True, **CASES["fp32"])
    out = render_rays(params, build_statics(MODEL_CFG), anneal,
                      torch.from_numpy(golden["rays"]),
                      torch.from_numpy(golden["background"]), rcfg)
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), golden[f"out/fp32/{k}"],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("with_fw", [False, True])
def test_port_checkpoint_loads_in_jax(tmp_path, with_fw):
    statics = build_statics(MODEL_CFG)
    params = init_params(torch.Generator().manual_seed(3), statics,
                         with_nof=True, with_fw_nof=with_fw)
    path = str(tmp_path / "final")
    tck.save_checkpoint(path, {"params": params}, extra={"clock": {
        "epoch": 1, "minibatch": 0, "step": 7}})
    tree, extra = jck.load_checkpoint(path)
    assert extra["clock"]["step"] == 7
    want = _leaves(tck.params_to_jax(params))
    assert _leaves(tree["params"]).keys() == want.keys()
    for k, v in _leaves(tree["params"]).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    # and it overlays a JAX-initialised tree of the same model, leaf for leaf
    jparams = j_init(jax.random.key(0), MODEL_CFG, j_statics(MODEL_CFG),
                     with_nerf=True, with_nof=True, with_fw_nof=with_fw)
    merged = _leaves(jck.merge_into(jparams, tree["params"], strict=True))
    for k, v in merged.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_params_roundtrip_and_partial_merge():
    statics = build_statics(MODEL_CFG)
    params = init_params(torch.Generator().manual_seed(1), statics,
                         with_nof=True)
    back = tck.params_from_jax(tck.params_to_jax(params))
    for k, v in tck._flatten(back).items():
        np.testing.assert_array_equal(v, tck._flatten(params)[k])
    # strict=False: missing and mis-shaped leaves keep their current value
    other = init_params(torch.Generator().manual_seed(2), statics,
                        with_nof=True)
    partial = {"coarse_NeRF": tck.params_to_jax(other["coarse_NeRF"]),
               "bw_NoF": {"head": {"w": np.zeros((1, 1), np.float32)}}}
    merged = tck.merge_into(params, partial)
    np.testing.assert_array_equal(merged["coarse_NeRF"]["trunk"][0]["w"],
                                  other["coarse_NeRF"]["trunk"][0]["w"])
    np.testing.assert_array_equal(merged["bw_NoF"]["head"]["w"],
                                  params["bw_NoF"]["head"]["w"])
    with pytest.raises(KeyError):
        tck.merge_into(params, partial, strict=True)


def test_find_latest_checkpoint(tmp_path):
    for step in (10, 200, 30):
        tck.save_checkpoint(str(tmp_path / "run" / "ckpts" /
                                f"epoch1_iter{step}"), {"a": np.ones(1)})
    latest = tck.find_latest_checkpoint(
        os.path.join(str(tmp_path), "*", "ckpts", "*.npz"))
    assert latest.endswith("epoch1_iter200")
