"""The port's reference-checkpoint converter
(``moco_flow_tpu_torch/scripts/convert_ref_ckpt.py``) against JAX's
``scripts/convert_ref_ckpt.py``, on the CPU.

A reference save_dict is fabricated by JAX's ``reverse_checkpoint`` from
seeded JAX parameters (a NeRF with the 'ind' frame feature and both NoFs,
a NeRF with the 'dir' feature, a hash-grid NeRF), with optimizer and
scheduler entries beside them. Each package converts it and saves it with
its own ``save_checkpoint``: the .npz arrays must be equal to the bit (same
keys, dtypes and values: the conversion is a transpose and a row
permutation) and the JSON sidecars equal. ``--reverse`` gives the same
tensors as JAX's and converts back to the same tree, and the CLIs agree
with ``--config`` read by the port's YAML reader and by PyYAML.
"""

import sys

import jax
import numpy as np
import pytest
import torch

from moco_flow_tpu.train.checkpoint import load_checkpoint as jax_load
from moco_flow_tpu.train.checkpoint import save_checkpoint as jax_save
from moco_flow_tpu.train.factory import build_statics, init_params
from moco_flow_tpu_torch.scripts import convert_ref_ckpt as port
from moco_flow_tpu_torch.train.checkpoint import load_checkpoint
from moco_flow_tpu_torch.utils.config import dump_config
from scripts import convert_ref_ckpt as ref_conv

NOF = {"type": "NoF", "D": 3, "W": 32, "in_channels_xyz": 33, "skips": [1],
       "extra_feat_type": "ind", "extra_feat_dim": 33, "use_quat": True}


def nerf(extra: str, dim: int, **kw) -> dict:
    return dict({"type": "NeRF", "D": 4, "W": 32, "in_channels_xyz": 39,
                 "skips": [2], "extra_feat_type": extra,
                 "extra_feat_dim": dim}, **kw)


HASH = {"encoding": "hashgrid", "D": 2, "skips": [],
        "hash": {"n_levels": 4, "n_features": 2, "log2_table_size": 8,
                 "base_res": 4, "max_res": 32}}
# model block, extra_pe_channels, whether the NoFs exist
CASES = {
    "ind": ({"N_importance": 8, "coarse_NeRF": nerf("ind", 5),
             "fine_NeRF": nerf("ind", 5), "bw_NoF": NOF, "fw_NoF": NOF},
            1, True),
    "dir": ({"N_importance": 8, "coarse_NeRF": nerf("dir", 27),
             "fine_NeRF": nerf("dir", 27)}, 3, False),
    "hash": ({"N_importance": 0, "coarse_NeRF": nerf("ind", 5, **HASH)},
             1, False),
}
CLOCK = {"epoch": 3, "minibatch": 5, "step": 777}


def jax_tree(case: str, seed: int = 0) -> dict:
    model, _, nofs = CASES[case]
    params = init_params(jax.random.key(seed), model, build_statics(model),
                         with_nof=nofs, with_fw_nof=nofs)
    return {"params": jax.tree_util.tree_map(np.asarray, params)}


def reference_dict(case: str) -> dict:
    """A reference trainer's save_dict: JAX's reverse of seeded params,
    plus optimizer / scheduler state the converter must skip."""
    _, epc, _ = CASES[case]
    sd, _ = ref_conv.reverse_checkpoint(jax_tree(case), {"clock": CLOCK},
                                        epc)
    sd["moco_optimizer"] = {"state": {}, "param_groups": []}
    sd["moco_scheduler"] = {"last_epoch": 3}
    return sd


def assert_same_files(got: str, want: str):
    with np.load(got + ".npz") as g, np.load(want + ".npz") as w:
        assert sorted(g.files) == sorted(w.files)
        for k in w.files:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    with open(got + ".json") as g, open(want + ".json") as w:
        assert g.read() == w.read()


def assert_same_state(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], torch.Tensor):
            assert got[k].dtype == want[k].dtype, k
            assert torch.equal(got[k], want[k]), k
        elif isinstance(want[k], dict):
            assert_same_state(got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("case", list(CASES))
def test_convert_matches_jax(case, tmp_path):
    _, epc, nofs = CASES[case]
    sd = reference_dict(case)
    tree, extra, skipped = port.convert_checkpoint(sd, epc)
    jtree, jextra, jskipped = ref_conv.convert_checkpoint(sd, epc)
    assert sorted(skipped) == sorted(jskipped) == ["moco_optimizer",
                                                   "moco_scheduler"]
    assert extra == jextra == {"clock": CLOCK}
    port.save_checkpoint(str(tmp_path / "port"), tree, extra=extra)
    jax_save(str(tmp_path / "jax"), jtree, extra=jextra)
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    # the reverse of JAX's own params converts back to them (the hash
    # table has no reference counterpart)
    got, _ = load_checkpoint(str(tmp_path / "port"))
    want = jax_tree(case)["params"]
    for net in want:
        want[net].pop("hash", None)
    flat_g = jax.tree_util.tree_leaves_with_path(got["params"])
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (p, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(p))
    assert ("bw_NoF" in got["params"]) == nofs


@pytest.mark.parametrize("case", list(CASES))
def test_reverse_matches_jax_and_round_trips(case):
    _, epc, _ = CASES[case]
    tree = jax_tree(case, seed=1)
    tree["opt_named"] = {"moco": {"mu": np.zeros(3, np.float32)}}
    got, skipped = port.reverse_checkpoint(tree, {"clock": CLOCK}, epc)
    want, jskipped = ref_conv.reverse_checkpoint(tree, {"clock": CLOCK}, epc)
    assert_same_state(got, want)
    assert skipped == jskipped and "opt_named" in skipped
    assert ("coarse_NeRF.hash" in skipped) == (case == "hash")
    back, extra, _ = port.convert_checkpoint(got, epc)
    assert extra == {"clock": CLOCK}
    for net, p in back["params"].items():
        for (path, g), (_, w) in zip(
                jax.tree_util.tree_leaves_with_path(p),
                jax.tree_util.tree_leaves_with_path(
                    {k: v for k, v in tree["params"][net].items()
                     if k != "hash"})):
            np.testing.assert_array_equal(g, w, err_msg=net + str(path))


@pytest.mark.parametrize("case", ["ind", "dir"])
def test_cli_with_config(case, tmp_path, monkeypatch, capsys):
    """Both CLIs, forward and --reverse, with the stage YAML as --config:
    the port reads it with utils/config.py, JAX's with PyYAML; the flags'
    defaults would be wrong for 'dir' (3 PE channels)."""
    model, _, _ = CASES[case]
    cfg = str(tmp_path / "stage.yaml")
    dump_config({"model": model, "trainer": {"num_iters": 1}}, cfg)
    assert port.config_channels(cfg) == (
        {"nof_in_channels_xyz": 33} if case == "ind"
        else {"extra_pe_channels": 3})
    pth = str(tmp_path / "ref.pth")
    torch.save(reference_dict(case), pth)
    port.main([pth, str(tmp_path / "port"), "--config", cfg])
    monkeypatch.setattr(sys, "argv", ["convert_ref_ckpt.py", pth,
                                      str(tmp_path / "jax"), "--config", cfg])
    ref_conv.main()
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
    out = capsys.readouterr().out
    assert "skipped" in out and "moco_optimizer" in out

    port.main([str(tmp_path / "port.npz"), str(tmp_path / "back_port"),
               "--reverse", "--config", cfg])
    monkeypatch.setattr(sys, "argv", ["convert_ref_ckpt.py",
                                      str(tmp_path / "jax.npz"),
                                      str(tmp_path / "back_jax.pth"),
                                      "--reverse", "--config", cfg])
    ref_conv.main()
    got = torch.load(str(tmp_path / "back_port.pth"), weights_only=False)
    want = torch.load(str(tmp_path / "back_jax.pth"), weights_only=False)
    assert_same_state(got, want)
    ref = reference_dict(case)
    assert_same_state(got, {k: v for k, v in ref.items()
                            if k.endswith("_net") or k == "clock"})
    # the port's converted checkpoint is what JAX's loader reads
    tree, extra = jax_load(str(tmp_path / "port"))
    assert extra["clock"] == CLOCK and "coarse_NeRF" in tree["params"]
