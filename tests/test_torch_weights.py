"""The port's weight path against the JAX package: the numpy safetensors
reader, BatchNorm folding / head fusion / stem bake (bit for bit), and the
JAX-layout -> module carry-across (value for value)."""

import os

import numpy as np
import pytest
import torch

from tpucenterface.config import PreprocessConfig as JPre
from tpucenterface.weights import fold as jfold
from tpucenterface.weights.port import torch_state_from_flax
from tpucenterface_torch.config import ModelConfig, PreprocessConfig
from tpucenterface_torch.model.centernet import CenterFaceNet
from tpucenterface_torch.weights import fold as tfold
from tpucenterface_torch.weights.convert import (
    state_dict_from_variables,
    variables_from_state_dict,
)
from tpucenterface_torch.weights.io import load_safetensors, read_safetensors_flat
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ARTIFACT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "artifacts",
    "flagship.safetensors",
)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.fixture(scope="module")
def flagship():
    return load_safetensors(ARTIFACT)


def test_reader_matches_safetensors_package():
    """Key for key, dtype, shape and bytes equal to safetensors.numpy."""
    from safetensors.numpy import load_file

    ref = load_file(ARTIFACT)
    got = read_safetensors_flat(ARTIFACT)
    assert sorted(got) == sorted(ref)
    assert len(got) == 302
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert got[k].tobytes() == v.tobytes(), k


def test_reader_rejects_truncated_file(tmp_path):
    data = open(ARTIFACT, "rb").read()
    bad = tmp_path / "cut.safetensors"
    bad.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError):
        read_safetensors_flat(str(bad))


def test_nested_tree_split_on_slash(flagship):
    assert set(flagship) == {"params", "batch_stats"}
    k = flagship["params"]["backbone"]["stem"]["conv"]["kernel"]
    assert k.shape == (3, 3, 3, 32) and k.dtype == np.float32


@pytest.mark.parametrize("fuse,bake", [(False, False), (True, False), (True, True)])
def test_fold_bit_identical_to_jax(flagship, fuse, bake):
    """fold_variables (+ fuse_heads, + stem bake) equals the JAX output bit
    for bit on the flagship tree."""
    ref = jfold.fold_variables(
        flagship, fuse_heads=fuse, bake_preprocess=JPre() if bake else None
    )
    got = tfold.fold_variables(
        flagship, fuse_heads=fuse, bake_preprocess=PreprocessConfig() if bake else None
    )
    ref_flat = dict(_flat(ref))
    got_flat = dict(_flat(got))
    assert sorted(got_flat) == sorted(ref_flat)
    for k, v in ref_flat.items():
        assert got_flat[k].dtype == v.dtype and got_flat[k].shape == v.shape, k
        assert got_flat[k].tobytes() == v.tobytes(), k


def test_raw_pixel_offset_matches_jax():
    for bgr in (True, False):
        a = tfold.raw_pixel_offset(PreprocessConfig(bgr_input=bgr))
        b = jfold.raw_pixel_offset(JPre(bgr_input=bgr))
        assert a.tobytes() == b.tobytes()


def test_carry_across_matches_jax_port_mapping(flagship):
    """state_dict_from_variables equals the JAX package's own mapping
    (weights/port.py::torch_state_from_flax) key for key, value for value."""
    ref = torch_state_from_flax(flagship)
    got = state_dict_from_variables(flagship)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


def test_carry_across_values_not_just_shapes(flagship):
    """A 1x1 kernel keeps its shape when transposed the wrong way round
    ((1,1,C,C) square), so check values: weight[o, i] == kernel[0, 0, i, o];
    depthwise (3,3,1,C) becomes (C,1,3,3); the folded, fused heads' block-
    diagonal out kernel is carried too. The round trip is exact."""
    folded = tfold.fold_variables(flagship, fuse_heads=True)
    sd = state_dict_from_variables(folded)
    p = folded["params"]
    proj = p["backbone"]["block_0"]["project"]["conv"]["kernel"]     # (1,1,32,16)
    w = sd["backbone.block_0.project.conv.weight"].numpy()
    assert w.shape == (16, 32, 1, 1)
    for o in range(16):
        for i in range(32):
            assert w[o, i, 0, 0] == proj[0, 0, i, o]
    dw = p["backbone"]["block_1"]["depthwise"]["conv"]["kernel"]      # (3,3,1,96)
    wd = sd["backbone.block_1.depthwise.conv.weight"].numpy()
    assert wd.shape == (96, 1, 3, 3)
    np.testing.assert_array_equal(wd[:, 0], np.transpose(dw[:, :, 0, :], (2, 0, 1)))
    out = p["heads"]["fused"]["out"]["kernel"]                        # (1,1,72,5)
    np.testing.assert_array_equal(sd["heads.fused.out.weight"].numpy()[:, :, 0, 0], out[0, 0].T)
    back = variables_from_state_dict(sd)
    for k, v in _flat(folded):
        np.testing.assert_array_equal(dict(_flat(back))[k], v, err_msg=str(k))


def test_state_dict_loads_into_port_modules(flagship):
    """The carried state_dict fills every parameter of the unfolded and the
    folded+fused model exactly (strict load, no missing or extra keys)."""
    net = CenterFaceNet(ModelConfig())
    net.load_state_dict(state_dict_from_variables(flagship), strict=True)
    folded = tfold.fold_variables(flagship, fuse_heads=True, bake_preprocess=PreprocessConfig())
    net = CenterFaceNet(ModelConfig(folded=True, fused_heads=True, stem_preprocess=True))
    net.load_state_dict(state_dict_from_variables(folded), strict=True)
    stem = folded["params"]["backbone"]["stem"]["conv"]["kernel"]
    np.testing.assert_array_equal(
        net.backbone.stem.conv.weight.detach().numpy(),
        torch.from_numpy(np.ascontiguousarray(np.transpose(stem, (3, 2, 0, 1)))).numpy(),
    )
