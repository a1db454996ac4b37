"""The stage 1/2 -> 3 hand-over of the port against the JAX package.

One stage-1 checkpoint (JAX's ``init_nerf.yaml``-shaped coarse and fine
NeRFs with the ``dir`` extra of 27, drawn by JAX and written by JAX's
``save_checkpoint``) and one stage-2 checkpoint (JAX's bw / fw NoFs) go
into a stage-3 model at fixture widths (the ``ind`` extra of 5 in place of
``dir``; the NoF input width is the stage-3 model's, which the weights
carry as they are, as in JAX: stage 2's 33 inputs from 0 bands meet
c2f's 33 from 5):

- ``sigma_branch_params``, ``transfer_pretrained_nerf`` and
  ``transfer_pretrained_nof`` against JAX's on the same trees, exactly:
  the fine NeRF's trunk / sigma / final into both NeRFs, extra / rgb kept,
  both NoFs copied;
- ``MoCoFlowTrainer.build_model`` with ``pretrained_nerf`` and
  ``pretrained_nof`` set gives JAX's trainer's moved tensors exactly and
  its own fresh draw elsewhere; with ``pretrained_path`` too, that
  checkpoint wins, as in JAX's order;
- a mismatched shape raises instead of loading.

All comparisons are exact: the hand-over copies tensors.
"""

import copy
import tempfile

import numpy as np
import pytest
import jax

import torch_port_env  # noqa: F401  (this worker's CPU share)
from moco_flow_tpu.nn import nerf as jnerf
from moco_flow_tpu.nn.nof import NoFConfig as JNoFConfig, init_nof
from moco_flow_tpu.train import checkpoint as jckpt
from moco_flow_tpu_torch.nn.nerf import sigma_branch_params
from moco_flow_tpu_torch.train import checkpoint as tckpt
from moco_flow_tpu_torch.train.checkpoint import (_flatten, load_checkpoint,
                                                  params_from_jax)
from moco_flow_tpu_torch.train.stage_mocoflow import MoCoFlowTrainer
from scripts.make_torch_port_train_golden import train_config

S1_NERF = dict(depth=4, width=32, in_channels_xyz=27, skips=(2,),
               extra_feat_type="dir", extra_feat_dim=27)
S2_NOF = dict(depth=4, width=32, in_channels_xyz=21, skips=(2,),
              extra_feat_dim=33, use_quat=True)
MOVED = ("trunk", "sigma", "final")


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """A stage-1 and a stage-2 checkpoint written by the JAX package."""
    d = tmp_path_factory.mktemp("handover")
    k = jax.random.split(jax.random.key(5), 4)
    s1 = {"coarse_NeRF": jnerf.init_nerf(k[0], jnerf.NeRFConfig(**S1_NERF)),
          "fine_NeRF": jnerf.init_nerf(k[1], jnerf.NeRFConfig(**S1_NERF))}
    s2 = {"bw_NoF": init_nof(k[2], JNoFConfig(**S2_NOF)),
          "fw_NoF": init_nof(k[3], JNoFConfig(**S2_NOF))}
    paths = {"nerf": str(d / "stage1_final"), "nof": str(d / "stage2_final")}
    jckpt.save_checkpoint(paths["nerf"], {"params": s1},
                          extra={"clock": {"epoch": 1, "minibatch": 0,
                                           "step": 200000}})
    jckpt.save_checkpoint(paths["nof"], {"params": s2},
                          extra={"clock": {"epoch": 1, "minibatch": 0,
                                           "step": 600000}})
    return paths, s1, s2


def _config(paths: dict | None, pretrained_path=None) -> dict:
    cfg = train_config("scene", "log")
    m = cfg["model"]
    m["pretrained_nerf"] = paths and paths["nerf"] + ".npz"
    m["pretrained_nof"] = paths and paths["nof"] + ".npz"
    m["pretrained_path"] = pretrained_path
    return cfg


def _port(cfg: dict, seed: int = 0) -> MoCoFlowTrainer:
    tr = MoCoFlowTrainer(copy.deepcopy(cfg), device="cpu", seed=seed)
    tr.build_model(cfg["model"])
    return tr


def _jax(cfg: dict):
    """JAX's ``MoCoFlowTrainer.build_model`` alone (no dataset)."""
    from moco_flow_tpu.train.stage_mocoflow import MoCoFlowTrainer as JT
    from moco_flow_tpu.utils.config import Config
    jt = JT.__new__(JT)
    # Config in train mode makes its log directories under save_dir
    jt.config = Config(dict(copy.deepcopy(cfg), save_dir=tempfile.mkdtemp()),
                       mode="train")
    jt.record_str = lambda s: None
    jt.build_model(jt.config["model"])
    return jt


def test_sigma_branch_params_matches_jax(ckpts):
    _, s1, _ = ckpts
    want = jnerf.sigma_branch_params(s1["fine_NeRF"])
    got = sigma_branch_params(params_from_jax(s1["fine_NeRF"]))
    assert set(got) == set(want) == set(MOVED)
    fw, fg = jckpt._flatten(want), _flatten(got)
    assert set(fw) == set(fg)
    for k, v in fw.items():
        np.testing.assert_array_equal(fg[k], np.asarray(v), err_msg=k)


def test_transfers_match_jax(ckpts):
    """The port's transfers on the port's fresh stage-3 tree against JAX's
    transfers on the same tree, read from the same checkpoints."""
    paths, _, _ = ckpts
    fresh = _port(_config(None)).params
    jtree = jax.tree.map(np.asarray, tckpt.params_to_jax(fresh))
    want = jckpt.transfer_pretrained_nof(jckpt.transfer_pretrained_nerf(
        jtree, jckpt.load_checkpoint(paths["nerf"])[0]),
        jckpt.load_checkpoint(paths["nof"])[0])
    got = tckpt.transfer_pretrained_nof(tckpt.transfer_pretrained_nerf(
        fresh, load_checkpoint(paths["nerf"])[0]),
        load_checkpoint(paths["nof"])[0])
    fw, fg = jckpt._flatten(want), _flatten(got)
    assert set(fw) == set(fg)
    for k, v in fw.items():
        np.testing.assert_array_equal(fg[k], np.asarray(v), err_msg=k)
    s1 = load_checkpoint(paths["nerf"])[0]["params"]["fine_NeRF"]
    for net in ("coarse_NeRF", "fine_NeRF"):
        for k, v in _flatten(got[net]).items():
            if k.split("/")[0] in MOVED:
                np.testing.assert_array_equal(v, _flatten(s1)[k])
            else:                                   # extra / rgb: fresh
                np.testing.assert_array_equal(v, _flatten(fresh[net])[k])


def test_build_model_hands_over_as_jax(ckpts):
    paths, _, _ = ckpts
    cfg = _config(paths)
    tr, jt = _port(cfg), _jax(cfg)
    own = _flatten(_port(_config(None)).params)
    got, want = _flatten(tr.params), jckpt._flatten(jt.params)
    assert set(got) == set(want)
    moved = 0
    for k, v in got.items():
        net, branch = k.split("/")[:2]
        if net.endswith("NoF") or branch in MOVED:
            np.testing.assert_array_equal(v, np.asarray(want[k]), err_msg=k)
            moved += 1
        else:
            np.testing.assert_array_equal(v, own[k], err_msg=k)
    assert 0 < moved < len(got)


def test_pretrained_path_wins_after_the_hand_over(ckpts, tmp_path):
    """JAX's order: the hand-over, then ``pretrained_path`` merged over
    it."""
    paths, _, _ = ckpts
    other = _port(_config(None), seed=3)
    other.job_dir = str(tmp_path)
    path = other.save_ckpt("stage3")
    cfg = _config(paths, pretrained_path=path + ".npz")
    got, want = _flatten(_port(cfg).params), _flatten(other.params)
    jwant = jckpt._flatten(_jax(cfg).params)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
        np.testing.assert_array_equal(v, np.asarray(jwant[k]), err_msg=k)


def test_mismatched_shapes_refuse_to_load(ckpts):
    paths, _, _ = ckpts
    params = _port(_config(None)).params
    tree = load_checkpoint(paths["nerf"])[0]
    tree["params"]["fine_NeRF"]["sigma"]["w"] = np.zeros((3, 1), np.float32)
    with pytest.raises(ValueError, match="sigma"):
        tckpt.transfer_pretrained_nerf(params, tree)
    with pytest.raises(KeyError, match="fine_NeRF"):
        tckpt.transfer_pretrained_nerf(params,
                                       {"params": {"coarse_NeRF": {}}})
