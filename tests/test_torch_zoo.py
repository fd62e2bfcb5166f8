"""The port's zoo families (``seldon_core_tpu_torch/models/{mlp,cnn,resnet,
bert}.py``) against the JAX package's flax models on the CPU.

Each family runs at its ``tiny`` preset on flax variables from
``jax.jit(init_params)``, perturbed from a numpy seed before either side
sees them: every bias, LayerNorm and BatchNorm scale, and BatchNorm mean
and variance (>= 0.5) is drawn, since flax's initial values (zero biases,
unit statistics, ``bn3`` at scale 0) would hide a wrong bias, statistic or
residual.  ``jax.jit(apply)`` and the port's forward take the same inputs,
made from a numpy seed; the JAX outputs are computed once per family.

Tolerances, on log-probabilities (each row is a softmax, and on many
classes an absolute limit on a probability says little):
- float32: 1e-5 (the two sides sum in other orders: ~1e-7 seen);
- bfloat16 weights on both sides: 0.05, argmax equal.  Both round every
  product to bf16 (2**-8 relative) but in different places: flax promotes
  float32 rows against bf16 weights to float32 math (MLP, CNN, ResNet on
  float input) where the port computes in the weights' dtype, and XLA
  fuses elementwise chains in float32 where torch rounds each op
  (ROADMAP C4); ~0.015 seen.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.models import registry as jax_registry
from seldon_core_tpu_torch.models import registry, resnet, zoo
from seldon_core_tpu_torch.models.weights import _flat_tree, zoo_from_flax

F32_LOG_TOL = 1e-5
BF16_LOG_TOL = 0.05

CASES = {
    "mlp": ("rows",),
    "cnn": ("flat", "nhwc"),
    "resnet": ("nhwc", "flat", "uint8"),
    "bert": ("padded", "max_len"),
}
PAIRS = [(family, case) for family, cases in CASES.items() for case in cases]
# bf16 on the path each family serves (ResNet: uint8 pixels)
BF16_PAIRS = [("mlp", "rows"), ("cnn", "nhwc"), ("resnet", "uint8"), ("bert", "padded")]


def perturb(variables, rng):
    """Draw every bias, scale and BatchNorm statistic from ``rng``."""
    def draw(path, leaf):
        a = np.asarray(leaf, np.float32)
        name = path[-1].key
        if name == "bias":
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.normal(0.0, 0.2, a.shape)).astype(np.float32)
        if name == "mean":
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(draw, variables)


def make_inputs(family, cfg, rng) -> dict:
    if family == "mlp":
        return {"rows": rng.normal(size=(5, cfg.in_features)).astype(np.float32)}
    if family in ("cnn", "resnet"):
        shape = (3, cfg.image_size, cfg.image_size, cfg.channels)
        x = rng.normal(size=shape).astype(np.float32)
        out = {"nhwc": x, "flat": x.reshape(3, -1)}
        if family == "resnet":  # raw pixels, normalized inside the forward
            out["uint8"] = rng.integers(0, 256, size=shape, dtype=np.uint8)
        return out
    ids = rng.integers(1, cfg.vocab_size, size=(4, 16)).astype(np.int32)
    ids[1, 9:] = cfg.pad_id
    ids[2, 3:] = cfg.pad_id
    ids[3, :] = cfg.pad_id  # all padding: a uniform softmax over masked keys
    full = rng.integers(1, cfg.vocab_size, size=(2, cfg.max_len)).astype(np.int32)
    return {"padded": ids, "max_len": full}


def _reference(family: str) -> dict:
    cfg = jax_registry.resolve_config(family, "tiny")
    fam = jax_registry.get_family(family)
    init = jax.device_get(jax.jit(lambda k: fam.init_params(k, cfg))(jax.random.PRNGKey(0)))
    variables = perturb(init, np.random.default_rng(1))
    apply = jax.jit(lambda p, x: fam.apply(p, x, cfg))
    bf16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), variables)
    inputs = make_inputs(family, cfg, np.random.default_rng(2))
    # the JAX model reshapes flat rows to the NHWC batch first: the NHWC
    # output is its answer to the flat rows too (one compile fewer)
    f32 = {k: np.asarray(apply(variables, x)) for k, x in inputs.items() if k != "flat"}
    if "flat" in inputs:
        f32["flat"] = f32["nhwc"]
    return {
        "init": init,
        "variables": variables,
        "inputs": inputs,
        "f32": f32,
        "bf16": {k: np.asarray(apply(bf16, inputs[k])).astype(np.float32)
                 for f, k in BF16_PAIRS if f == family},
    }


@pytest.fixture(scope="module")
def ref():
    cache: dict = {}

    def get(family):
        if family not in cache:
            cache[family] = _reference(family)
        return cache[family]

    return get


def _port(family, variables, dtype=None):
    cfg = registry.resolve_family_config(family, "tiny")
    return zoo_from_flax(family, variables, cfg, dtype=dtype, device="cpu")


def _run(module, x) -> np.ndarray:
    with torch.no_grad():
        return module(torch.from_numpy(x)).float().numpy()


@pytest.mark.parametrize("family,case", PAIRS)
def test_float32_forward_matches_jax(ref, family, case):
    r = ref(family)
    got = _run(_port(family, r["variables"]), r["inputs"][case])
    want = r["f32"][case]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(np.log(got), np.log(want), rtol=0, atol=F32_LOG_TOL)


@pytest.mark.parametrize("family,case", BF16_PAIRS)
def test_bfloat16_forward_matches_jax(ref, family, case):
    r = ref(family)
    got = _run(_port(family, r["variables"], torch.bfloat16), r["inputs"][case])
    want = r["bf16"][case]
    np.testing.assert_allclose(np.log(got), np.log(want), rtol=0, atol=BF16_LOG_TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_bert_all_padding_row_is_a_uniform_attention(ref):
    """A row of only padding: every key masked with finfo.min, so each
    softmax is uniform and the row stays finite (JAX: the same row)."""
    r = ref("bert")
    got = _run(_port("bert", r["variables"]), r["inputs"]["padded"])
    assert np.isfinite(got[3]).all()
    np.testing.assert_allclose(np.log(got[3]), np.log(r["f32"]["padded"][3]), atol=F32_LOG_TOL)


@pytest.mark.parametrize("family", list(CASES))
def test_bridge_refuses_a_missing_or_extra_key(ref, family):
    variables = ref(family)["variables"]
    flat = _flat_tree(variables)
    gone = sorted(flat)[len(flat) // 2]
    collection, *path = gone.split("/")
    trimmed = jax.tree_util.tree_map(lambda a: a, variables)  # a deep copy of the dicts
    node = trimmed[collection]
    for key in path[:-1]:
        node = node[key]
    del node[path[-1]]
    with pytest.raises(KeyError, match=gone):
        _port(family, trimmed)
    extra = dict(variables, params=dict(variables["params"], stray={"kernel": np.zeros(3)}))
    with pytest.raises(KeyError, match="params/stray/kernel"):
        _port(family, extra)


def test_same_padding_is_asymmetric_at_stride_2():
    assert zoo.same_padding(8, 3, 2) == (0, 1)  # the bottleneck's conv2, the stem pool
    assert zoo.same_padding(7, 3, 2) == (1, 1)
    assert zoo.same_padding(8, 1, 2) == (0, 0)  # the 1x1/2 projection
    assert zoo.same_padding(28, 5, 1) == (2, 2)  # the CNN's 5x5 convolutions


@pytest.mark.parametrize("family", list(CASES))
def test_seeded_init_draws_the_flax_distributions(ref, family):
    """``init_params`` from a torch.Generator gives the module that flax's
    init tree bridges to (the same keys and shapes), flax's constant leaves
    (zero biases, unit norms and statistics, ``bn3`` at scale 0) and
    lecun-normal kernels, truncated at two standard deviations."""
    cfg = registry.resolve_family_config(family, "tiny")
    module = registry.get_family(family).init_params(cfg, torch.Generator().manual_seed(0))
    bridged = _port(family, ref(family)["init"])
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in bridged.state_dict().items()}
    for key, t in module.state_dict().items():
        want = bridged.state_dict()[key]
        if not key.endswith((".weight", ".kernel")) or isinstance(
                module.get_submodule(key.rpartition(".")[0]), torch.nn.LayerNorm):
            assert torch.equal(t, want), key  # a constant leaf, the same as flax's
    for mod in module.modules():
        if isinstance(mod, (torch.nn.Linear, torch.nn.Conv2d)) and mod.weight.numel() >= 2048:
            std = 1.0 / np.sqrt(mod.weight[0].numel())
            assert abs(float(mod.weight.std()) / std - 1.0) < 0.15
            assert float(mod.weight.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6


def test_resnet_uint8_ingest_equals_normalized_floats():
    """The uint8 path equals the same pixels normalized on the host."""
    cfg = registry.resolve_family_config("resnet", "tiny")
    module = resnet.init_params(cfg, torch.Generator().manual_seed(3))
    px = np.random.default_rng(4).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    norm = ((px.astype(np.float32) / 255.0 - np.float32(resnet.IMAGENET_MEAN))
            / np.float32(resnet.IMAGENET_STD)).astype(np.float32)
    np.testing.assert_allclose(_run(module, px), _run(module, norm), rtol=1e-6, atol=1e-7)
