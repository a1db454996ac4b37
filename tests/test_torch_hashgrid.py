"""The hash-grid encoding (``encoding: hashgrid``) of the port against the
JAX package.

- ``hashgrid_encode`` against JAX's on points that hit dense and hashed
  levels, points outside the box (clamped), lattice points and cell
  midpoints: 1e-6 of the largest feature (both interpolate the same fp32
  corners with the same weights; XLA may fuse the weighted sum otherwise);
  the hashed indices themselves equal JAX's uint32 hash exactly.
- The table's gradient (autograd's ``index_add``) against ``jax.grad``,
  1e-6 relative.
- The config plumbing: ``NeRFConfig.from_dict``, ``init_nerf``'s ``hash``
  leaf, ``render_config``'s errors and its ``auto`` / ``xla`` ->
  ``fused_nof``.
- One stage-1 step of the port's ``NeRFTrainer`` with a hash NeRF (2 x 16,
  no skips, a ``dir`` extra) and JAX's draws against JAX's step on its
  ``xla`` route: ``img_loss`` and ``train_psnr`` 1e-5 relative, the
  parameters 1e-6 absolute, the hash table's update 1e-4 of its largest
  element.
- The stage 1 -> 3 hand-over: the stage-3 hash table stays at its fresh
  init, and the freeze leaves it trainable, as JAX's code does.
"""

import copy
import json
import os.path as osp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.nn import hashgrid as jhash
from moco_flow_tpu.nn.nerf import NeRFConfig as JNeRFConfig
from moco_flow_tpu.train import checkpoint as jckpt
from moco_flow_tpu.train import factory as jfactory
from moco_flow_tpu.train.stage_mocoflow import _freeze_density as j_freeze
from moco_flow_tpu_torch.nn import hashgrid as thash
from moco_flow_tpu_torch.nn.nerf import NeRFConfig, init_nerf
from moco_flow_tpu_torch.nn.nerf import sigma_branch_params
from moco_flow_tpu_torch.train import checkpoint as tckpt
from moco_flow_tpu_torch.train.factory import render_config
from moco_flow_tpu_torch.train.stage_mocoflow import _freeze_density
from scripts.make_torch_port_stage1_golden import (SCENE, jax_draws,
                                                   jax_trainer, port_draws,
                                                   port_trainer,
                                                   stage1_config)

HASH = {"n_levels": 4, "n_features": 2, "log2_table_size": 10,
        "base_res": 4, "max_res": 32, "extent": 1.5}
HASH_NERF = {"type": "NeRF", "D": 2, "W": 16, "skips": [],
             "extra_feat_type": "dir", "extra_feat_dim": 27,
             "encoding": "hashgrid", "hash": HASH}


def _close(got, want, what, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol * scale:.3e}"


def _points() -> np.ndarray:
    """Random points, points beyond the box, lattice points and cell
    midpoints of the finest level."""
    rng = np.random.default_rng(0)
    cfg = jhash.HashGridConfig(**HASH)
    res = int(cfg.level_resolutions()[-1])
    lattice = (rng.integers(0, res + 1, (16, 3)) / res * 2 - 1) * 1.5
    mid = ((rng.integers(0, res, (16, 3)) + 0.5) / res * 2 - 1) * 1.5
    return np.concatenate([rng.uniform(-1.5, 1.5, (64, 3)),
                           rng.uniform(-3.0, 3.0, (16, 3)), lattice, mid,
                           [[1.5, 1.5, 1.5], [-1.5, -1.5, -1.5]]]
                          ).astype(np.float32)


def test_levels_are_dense_and_hashed():
    cfg = thash.HashGridConfig(**HASH)
    verts = (cfg.level_resolutions() + 1) ** 3
    assert (verts <= cfg.table_size).any() and (verts > cfg.table_size).any()
    assert np.array_equal(cfg.level_resolutions(),
                          jhash.HashGridConfig(**HASH).level_resolutions())


def test_corner_indices_match_jax():
    cfg = jhash.HashGridConfig(**HASH)
    rng = np.random.default_rng(1)
    for res in cfg.level_resolutions():
        res = int(res)
        i0 = rng.integers(0, res, (256, 3)).astype(np.int32)
        want = np.asarray(jhash._corner_indices(jnp.asarray(i0), res,
                                                cfg.table_size))
        got = thash._corner_indices(torch.from_numpy(i0).long(), res,
                                    cfg.table_size)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(res))


def test_encode_and_table_gradient_match_jax():
    jcfg = jhash.HashGridConfig(**HASH)
    tcfg = thash.HashGridConfig(**HASH)
    table = np.asarray(jax.random.normal(jax.random.key(2),
                                         (4, 1024, 2))) * 0.1
    x = _points()
    want = np.asarray(jhash.hashgrid_encode(jnp.asarray(table),
                                            jnp.asarray(x), jcfg))
    t = torch.from_numpy(table.astype(np.float32)).requires_grad_(True)
    got = thash.hashgrid_encode(t, torch.from_numpy(x), tcfg)
    _close(got.detach().numpy(), want, "encode")
    w = np.random.default_rng(3).normal(size=want.shape).astype(np.float32)
    jg = jax.grad(lambda tb: jnp.sum(jhash.hashgrid_encode(
        tb, jnp.asarray(x), jcfg) * w))(jnp.asarray(table))
    (got * torch.from_numpy(w)).sum().backward()
    _close(t.grad.numpy(), np.asarray(jg), "d table")


def test_config_plumbing():
    d = dict(HASH_NERF)
    got, want = NeRFConfig.from_dict(d), JNeRFConfig.from_dict(d)
    assert got.in_channels_xyz == want.in_channels_xyz == 8
    assert got.encoding == "hashgrid" and got.hash.out_dim == 8
    assert dataclasses_equal(got.hash, want.hash)
    p = init_nerf(torch.Generator().manual_seed(0), got)
    assert tuple(p["hash"].shape) == (4, 1024, 2)
    assert float(p["hash"].abs().max()) <= 1e-4
    assert p["trunk"][0]["w"].shape[0] == 8
    # a PE model draws what it drew before the table existed
    pe = NeRFConfig.from_dict({"D": 2, "W": 16, "skips": []})
    a = init_nerf(torch.Generator().manual_seed(5), pe)
    assert "hash" not in a
    assert set(sigma_branch_params(p)) == {"trunk", "sigma", "final", "hash"}
    with pytest.raises(ValueError, match="encoding"):
        NeRFConfig.from_dict({"encoding": "fourier"})


def dataclasses_equal(a, b) -> bool:
    return all(getattr(a, f) == getattr(b, f) for f in
               ("n_levels", "n_features", "log2_table_size", "base_res",
                "max_res", "extent"))


@pytest.mark.parametrize("impl", ["fused", "fused_nerf", "pallas"])
def test_render_config_refuses_hash_routes(impl):
    model = {"mlp_impl": impl, "fine_NeRF": HASH_NERF, "N_importance": 8}
    with pytest.raises(ValueError, match="hashgrid"):
        render_config(model)
    with pytest.raises(ValueError, match="hashgrid"):
        jfactory.render_config(model)


@pytest.mark.parametrize("impl", ["auto", "xla", "fused_nof", None])
def test_render_config_resolves_hash_to_fused_nof(impl):
    model = {"coarse_NeRF": HASH_NERF}
    if impl is not None:
        model["mlp_impl"] = impl
    assert render_config(model).mlp_impl == "fused_nof"
    assert render_config(model, test_time=True).mlp_impl == "fused_nof"
    assert render_config({"mlp_impl": impl or "auto"}).mlp_impl == \
        ("fused_nof" if impl == "fused_nof" else "fused")


@pytest.fixture(scope="module")
def hash_step(tmp_path_factory):
    """JAX's stage-1 step with a hash NeRF on its xla route, and the port's
    on the same data, weights and draws."""
    from moco_flow_tpu.data.synthetic import make_synthetic_scene
    tmp = str(tmp_path_factory.mktemp("hash"))
    root = osp.join(tmp, "scene")
    smpl = make_synthetic_scene(root, **SCENE)
    cfg = stage1_config(root, osp.join(tmp, "log"))
    cfg["model"].update(mlp_impl="xla", coarse_NeRF=copy.deepcopy(HASH_NERF),
                        fine_NeRF=copy.deepcopy(HASH_NERF))
    cfg["optimizer"]["lr"] = 1e-2
    jt = jax_trainer(cfg, smpl)
    ds, m = jt.train_dataset, cfg["model"]
    arrs = {"config_json": np.asarray(json.dumps(cfg))}
    arrs.update({f"params0/{k}": np.array(v)
                 for k, v in jckpt._flatten(jt.params).items()})
    for name in ("c2w", "near", "far", "norm_idx", "valid_idx",
                 "valid_count"):
        arrs[f"table/{name}"] = np.asarray(getattr(ds.table, name))
    arrs["directions"] = np.asarray(ds.directions_flat)
    arrs["images"] = np.asarray(ds.images)
    arrs["bkgd_img"] = np.asarray(ds.bkgd_img)
    arrs["rand_bkgd"] = np.asarray(ds.rand_bkgd)
    draws = jax_draws(0, jt.clock.step, ds.table, m["N_rand"],
                      m["N_samples"], m["N_importance"])
    arrs.update({f"draws/0/{k}": v for k, v in draws.items()})
    jm = {k: float(v) for k, v in jt.train_step().items()}
    tr = port_trainer(arrs, "cpu")
    assert tr.rcfg_train.mlp_impl == "fused_nof"
    tm = {k: float(v) for k, v in
          tr.train_step(draws=port_draws(arrs, 0)).items()}
    return jm, tm, jckpt._flatten(jt.params), tckpt._flatten(tr.params), \
        arrs


def test_hash_stage1_step_matches_jax(hash_step):
    jm, tm, jp, tp, arrs = hash_step
    assert set(tm) == set(jm)
    for k, v in jm.items():
        assert abs(tm[k] - v) <= 1e-5 * abs(v), (k, tm[k], v)
    assert set(tp) == set(jp)
    for k, v in jp.items():
        np.testing.assert_allclose(tp[k], np.asarray(v), rtol=0, atol=1e-6,
                                   err_msg=k)
    # the table's own update (~1e-6 a step, below that tolerance): 1e-4
    # of its largest element (measured 1.8e-5: the gather's transpose sums
    # a corner's contributions in another order than XLA's scatter)
    for net in ("coarse_NeRF", "fine_NeRF"):
        k = f"{net}/hash"
        p0 = arrs[f"params0/{k}"]
        upd = np.asarray(jp[k]) - p0
        assert np.abs(upd).max() > 0, k
        _close(tp[k] - p0, upd, f"{k} update", rtol=1e-4)


def test_handover_leaves_the_hash_table_fresh():
    """JAX's ``transfer_pretrained_nerf`` moves trunk / sigma / final only;
    the port's equals it, so the stage-3 table keeps its fresh init; the
    density freeze does not touch it."""
    cfg = NeRFConfig.from_dict(HASH_NERF)
    gen = torch.Generator().manual_seed(1)
    stage3 = {"coarse_NeRF": init_nerf(gen, cfg),
              "fine_NeRF": init_nerf(gen, cfg)}
    stage1 = {"fine_NeRF": init_nerf(torch.Generator().manual_seed(2), cfg)}
    got = tckpt.transfer_pretrained_nerf(stage3, {"params": stage1})
    want = jckpt.transfer_pretrained_nerf(
        tckpt.params_to_jax(stage3), {"params": tckpt.params_to_jax(stage1)})
    gf, wf = tckpt._flatten(got), jckpt._flatten(want)
    assert set(gf) == set(wf)
    for k, v in wf.items():
        np.testing.assert_array_equal(gf[k], np.asarray(v), err_msg=k)
    for net in ("coarse_NeRF", "fine_NeRF"):
        assert torch.equal(got[net]["hash"], stage3[net]["hash"])
        assert torch.equal(got[net]["trunk"][0]["w"],
                           stage1["fine_NeRF"]["trunk"][0]["w"])
    for path in ("coarse_NeRF/hash", "fine_NeRF/hash",
                 "coarse_NeRF/trunk/0/w", "fine_NeRF/sigma/b"):
        assert _freeze_density(path) == j_freeze(path), path
    assert not _freeze_density("coarse_NeRF/hash")
