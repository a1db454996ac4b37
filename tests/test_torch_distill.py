"""Student distillation (``moco_flow_tpu_torch/render/distill.py``) against
the JAX package's ``render/distill.py``.

- ``student_config`` as JAX's for several depths and widths;
- 3 distillation steps from JAX's student init and hot buffer, with JAX's
  draws of each step handed in (uniform points, jitter, the extra feature's
  draws), against JAX's ``distill_student(steps=3, swap=False)``: the
  student's parameters within 1e-5 of each leaf's largest magnitude
  (relative; the teacher and the student run the plain version of #8 here,
  fp32 products summed in another order than XLA's) and the final loss
  within 1e-5 relative, under ``relu`` (the dead-ReLU hinge on) and
  ``softplus``;
- ``swap_render_nerf`` installs the student as both NeRFs, clears the
  trainer's occupancy caches and makes ``train_step`` raise;
  ``distill_with_restarts`` restores the teacher before a retry;
- ``render_psnr_vs_teacher`` as JAX's.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.nn.nerf import NeRFConfig as JNeRFConfig, init_nerf
from moco_flow_tpu.render import distill as jdistill
from moco_flow_tpu.render import volume as jvol
from moco_flow_tpu.train.checkpoint import _flatten as j_flatten
from moco_flow_tpu_torch.nn.nerf import NeRFConfig
from moco_flow_tpu_torch.render import distill as tdistill
from moco_flow_tpu_torch.render import volume as tvol
from moco_flow_tpu_torch.train.checkpoint import _flatten, params_from_jax

RTOL = 1e-5
TEACHER = dict(depth=4, width=32, in_channels_xyz=27, skips=(2,),
               extra_feat_type="ind", extra_feat_dim=5)
STEPS, BATCH, SEED, EXTENT = 3, 64, 4, 1.5


def _statics(mod, cls, teacher):
    e = mod.EmbeddingSpec
    return mod.ModelStatics(coarse=cls(**teacher), fine=cls(**teacher),
                            nerf_xyz=e(4), nerf_ind=e(2, in_channels=1),
                            nerf_dir=e(4))


def _close(got, want, what, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol * scale:.3e}"


@pytest.mark.parametrize("depth,width", [(4, 128), (2, 64), (6, 48),
                                         (3, 32)])
def test_student_config_matches_jax(depth, width):
    t = dict(TEACHER, depth=8, width=256, skips=(4,))
    got = tdistill.student_config(NeRFConfig(**t), depth, width)
    want = jdistill.student_config(JNeRFConfig(**t), depth, width)
    assert (got.depth, got.width, got.skips, got.in_channels_xyz,
            got.extra_feat_type, got.extra_feat_dim, got.encoding) == \
        (want.depth, want.width, want.skips, want.in_channels_xyz,
         want.extra_feat_type, want.extra_feat_dim, want.encoding)


def _jax_draws(extra_type: str):
    """JAX's init, hot buffer and per-step draws of ``distill_student``,
    derived from its keys as it derives them."""
    key = jax.random.key(SEED)
    half = BATCH // 2
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    hot = t(jax.random.uniform(jax.random.fold_in(key, 2), (half, 3),
                               minval=-EXTENT, maxval=EXTENT))
    draws = []
    for i in range(STEPS):
        ku, kj, ke = jax.random.split(jax.random.fold_in(key, 100 + i), 3)
        if extra_type == "ind":
            e = t(jax.random.uniform(ke, (BATCH, 1), minval=-1.0,
                                     maxval=1.0))
        elif extra_type == "dir":
            e = t(jax.random.normal(ke, (BATCH, 3)))
        else:
            e = None
        draws.append(tdistill.DistillDraws(
            t(jax.random.uniform(ku, (half, 3), minval=-EXTENT,
                                 maxval=EXTENT)),
            t(jax.random.normal(kj, (half, 3))), e))
    return key, hot, draws


@pytest.mark.parametrize("activation,extra", [("relu", "ind"),
                                              ("softplus", "dir")])
def test_distill_steps_match_jax(activation, extra):
    teacher = dict(TEACHER, extra_feat_type=extra,
                   extra_feat_dim=5 if extra == "ind" else 27)
    jcfg = JNeRFConfig(**teacher)
    tparams = init_nerf(jax.random.key(31), jcfg)
    # a sharp field: some points occupied, others empty
    tparams["sigma"] = {"w": tparams["sigma"]["w"] * 20.0,
                        "b": jnp.full_like(tparams["sigma"]["b"], -0.5)}
    jtr = types.SimpleNamespace(
        statics=_statics(jvol, JNeRFConfig, teacher),
        params={"fine_NeRF": tparams},
        rcfg_test=jvol.RenderConfig(activation=activation))
    js, jscfg, jloss = jdistill.distill_student(
        jtr, depth=2, width=32, steps=STEPS, batch=BATCH, lr=3e-3,
        seed=SEED, swap=False)
    key, hot, draws = _jax_draws(extra)
    s0 = init_nerf(jax.random.fold_in(key, 1), jscfg)
    ttr = types.SimpleNamespace(
        statics=_statics(tvol, NeRFConfig, teacher),
        params={"fine_NeRF": params_from_jax(tparams)},
        rcfg_test=tvol.RenderConfig(activation=activation),
        device=torch.device("cpu"))
    ts, tscfg, tloss = tdistill.distill_student(
        ttr, depth=2, width=32, steps=STEPS, batch=BATCH, lr=3e-3,
        seed=SEED, swap=False, student_params=params_from_jax(s0),
        hot=hot, draws=lambda i: draws[i])
    assert (tscfg.depth, tscfg.width, tscfg.skips) == \
        (jscfg.depth, jscfg.width, jscfg.skips)
    _close(tloss, jloss, "loss")
    got = _flatten(ts)
    want = j_flatten(js)
    assert set(got) == set(want)
    moved, init = 0, j_flatten(s0)
    for k, v in want.items():
        _close(got[k], v, k)
        moved += not np.array_equal(np.asarray(v), np.asarray(init[k]))
    assert moved == len(want)


def _trainer():
    from moco_flow_tpu_torch.train.stage_nerf import NeRFTrainer
    nerf = {"D": 4, "W": 32, "in_channels_xyz": 27, "skips": [2],
            "extra_feat_type": "none"}
    cfg = {"model": {"type": "nerf", "N_samples": 8, "N_importance": 8,
                     "nerf_activate_type": "relu",
                     "nerf_embedding_xyz": {"N_freqs": 4},
                     "coarse_NeRF": nerf, "fine_NeRF": dict(nerf)},
           "trainer": {}}
    tr = NeRFTrainer(cfg, device="cpu")
    tr.build_model(cfg["model"])
    return tr


def test_swap_clears_caches_and_refuses_training(monkeypatch):
    tr = _trainer()
    tr._occ_grids[0] = "a grid of the teacher"
    tr._occ_keep = torch.ones(3, dtype=torch.bool)
    s, cfg, loss = tdistill.distill_student(tr, depth=2, width=16, steps=2,
                                            batch=32)
    assert np.isfinite(loss)
    assert tr.statics.coarse == tr.statics.fine == cfg
    assert tr.params["coarse_NeRF"] is s and tr.params["fine_NeRF"] is s
    assert not tr._occ_grids and tr._occ_keep is None
    with pytest.raises(RuntimeError, match="swap_render_nerf"):
        tr.train_step()
    rays = torch.tensor([[0.0, 0.0, 4.0, 0.0, 0.0, -1.0, 2.5, 5.5, 0.0]])
    out = tvol.render_rays(tr.params, tr.statics, {}, rays, None,
                           tr.rcfg_test)
    assert torch.isfinite(out["rgb_fine"]).all()
    # a retry restores the teacher first
    tr2 = _trainer()
    teacher2 = tr2.params
    seen = []
    real = tdistill.distill_student

    def fake(trainer, seed, **kw):
        seen.append((seed, trainer.params is teacher2))
        out = real(trainer, seed=seed, **kw)
        return out[0], out[1], 1.0          # "diverged": retry
    monkeypatch.setattr(tdistill, "distill_student", fake)
    *_, seed = tdistill.distill_with_restarts(tr2, tries=2, depth=2,
                                              width=16, steps=1, batch=32)
    assert seed == 1 and seen == [(0, True), (1, True)]


def test_render_psnr_vs_teacher_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(8, 8, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.02, size=a.shape), 0, 1)
    assert tdistill.render_psnr_vs_teacher(a, b) == \
        jdistill.render_psnr_vs_teacher(a, b)
