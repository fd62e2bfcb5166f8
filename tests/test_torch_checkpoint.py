"""Checkpoints in the port against the JAX package, on the CPU.

* A tiny llama's params written by the JAX package's ``save_params`` load
  in the port's ``load_params``, and the port's files (numpy leaves or the
  port's own tensors) load in the JAX package's: every leaf equal as bytes
  with its dtype, in float32 and in bfloat16 (the port returns a bf16 leaf
  as a ``torch.bfloat16`` tensor over the stored bits, never widened), and
  the ``__skeleton__`` and ``__manifest__`` records equal byte for byte
  for the same tree.
* A port model built from the JAX file through the generative unit's
  ``checkpoint`` gives the JAX forward's teacher-forced logits (float32,
  ``LOGIT_TOL``) and the JAX scheduler's greedy streams; a checkpoint
  whose shapes do not fit the config is refused by name.
* The port's int8 KV pool (int8 pages, scales, table, positions) round
  trips bit for bit, as ``tests/test_spec.py`` pins for the JAX pool.
* Every refusal of the JAX module raises the same exception type in the
  port: non-str dict keys, a namedtuple, an unsupported container, a
  format version other than 2, an unknown skeleton node, a missing file.
* The zoo: ``zoo_to_flax`` gives the tree of flax's own ``init`` (its
  traced shapes); a JAX ``CompiledModel.save_checkpoint`` of flax
  variables held as a ``FrozenDict`` serves through the port's
  ``JAX_MODEL`` unit with ``checkpoint`` (log-probabilities within
  ``LOG_TOL``), and the port's ``save_checkpoint`` loads into JAX
  ``build_compiled(params=...)`` with the JAX predictions bit for bit.
* Trained Medusa heads: a JAX-format heads file served through
  ``spec_heads_path`` gives the JAX ``GenerativeModel``'s greedy tokens and
  acceptance ledger; each malformed file raises ``GraphUnitError``.
* ``mesh`` still raises by name on both units.
"""

import asyncio
import collections
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import freeze, unfreeze

from seldon_core_tpu.executor import checkpoint as jck
from seldon_core_tpu.executor.generation import GenerationScheduler as JaxScheduler
from seldon_core_tpu.executor.generation import GenerativeModel as JaxGenerativeModel
from seldon_core_tpu.models import llama as jl
from seldon_core_tpu.models import registry as jax_registry
from seldon_core_tpu_torch.executor import checkpoint as tck
from seldon_core_tpu_torch.executor.generation import GenerationScheduler, GenerativeModel
from seldon_core_tpu_torch.graph.spec import Implementation
from seldon_core_tpu_torch.graph.units import GraphUnitError, create_builtin
from seldon_core_tpu_torch.models import llama as tl
from seldon_core_tpu_torch.models import registry
from seldon_core_tpu_torch.models.weights import params_from_jax, params_to_jax, zoo_to_flax

LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_llama.py's
LOG_TOL = 1e-5  # tests/test_torch_predict.py's, on log-probabilities
PROMPTS = [[5, 9, 2, 17, 3], [30, 7], [1, 2, 3, 4]]
REPETITIVE = np.tile([3, 7, 11], 8).tolist()  # drafts are accepted here
MAX_NEW = 9


@pytest.fixture(scope="module")
def tiny():
    cfg = jl.Config.tiny(max_seq=64)
    jparams = jax.device_get(jax.jit(jl.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg))
    return cfg, jparams, tl.Config.tiny(max_seq=64)


@pytest.fixture(scope="module")
def files(tiny, tmp_path_factory):
    """The tiny params in float32 and bfloat16, each written by the JAX
    package: {dtype: (tree, path)}."""
    root = tmp_path_factory.mktemp("ckpt")
    out = {}
    for name in ("float32", "bfloat16"):
        tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, name)), tiny[1])
        path = str(root / f"jax_{name}.npz")
        jck.save_params(path, tree)
        out[name] = (tree, path)
    return out


def _leaves(tree) -> dict:
    flat = {k: v for k, v in tree.items() if k != "layers"}
    flat.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    return flat


def _bits(leaf) -> tuple[str, bytes]:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16", leaf.view(torch.int16).numpy().tobytes()
        leaf = leaf.numpy()
    leaf = np.asarray(leaf)
    return leaf.dtype.name, leaf.tobytes()


def _records(path) -> tuple[bytes, bytes]:
    with np.load(path) as z:
        return z["__skeleton__"].tobytes(), z["__manifest__"].tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_jax_file_loads_in_the_port_bit_for_bit(files, dtype):
    tree, path = files[dtype]
    got = tck.load_params(path)
    assert set(got) == set(tree) and set(got["layers"]) == set(tree["layers"])
    want = _leaves(tree)
    for key, leaf in _leaves(got).items():
        assert _bits(leaf) == _bits(want[key]), key
        if dtype == "bfloat16":  # over the stored bits, not widened
            assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_port_file_loads_in_jax_with_equal_records(files, tiny, tmp_path, dtype):
    tree, jax_path = files[dtype]
    # the same tree as numpy leaves, and as the port's own model tensors
    model = params_from_jax(tree, tiny[2])
    assert model.tok_emb.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    for name, src in (("numpy", tree), ("torch", params_to_jax(model))):
        path = str(tmp_path / f"{name}.npz")
        assert tck.save_params(path, src) == len(_leaves(tree))
        assert _records(path) == _records(jax_path), name
        back = jck.load_params(path)
        want = _leaves(tree)
        for key, leaf in _leaves(back).items():
            assert _bits(leaf) == _bits(want[key]), (name, key)


def test_logits_and_streams_of_a_checkpointed_unit_equal_jax(files, tiny):
    cfg, jparams, tcfg = tiny
    path = files["float32"][1]
    comp = create_builtin(Implementation.JAX_GENERATIVE, {
        "preset": "tiny", "max_seq": 64, "checkpoint": path, "n_slots": 2,
        "decode_block": 4, "seq_impl": "dense"}, device="cpu")
    toks = np.asarray([[5, 9, 2, 17, 3, 42, 8, 1]], np.int32)
    with torch.no_grad():
        got = comp.model.params(torch.from_numpy(toks), seq_impl="dense").numpy()
    np.testing.assert_allclose(got, np.asarray(jl.forward(jparams, toks, cfg)), **LOGIT_TOL)

    async def serve(sched):
        try:
            return [o.tolist() for o in await asyncio.gather(*(
                sched.submit(np.asarray(p, np.int32), max_new_tokens=MAX_NEW) for p in PROMPTS))]
        finally:
            await sched.close()

    want = asyncio.run(serve(JaxScheduler(JaxGenerativeModel(cfg, jparams, n_slots=2,
                                                             decode_block=4))))
    assert asyncio.run(serve(comp.scheduler)) == want
    # a file whose shapes do not fit the resolved config is refused by name
    with pytest.raises(GraphUnitError, match="checkpoint .* does not fit"):
        registry.build_generative_component(preset="tiny", max_seq=64, hidden=32,
                                            checkpoint=path, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_int8_pool_round_trips_bit_for_bit(files, tiny, tmp_path, dtype):
    model = GenerativeModel(tiny[2], params_from_jax(files["float32"][0], tiny[2]), n_slots=2,
                            decode_block=4, kv_cache_dtype="int8", dtype=dtype, device="cpu")
    model.admit(0, np.asarray(PROMPTS[0], np.int32), 0.0, 0, reserve_tokens=4)
    cache = {k: v.clone() for k, v in model._cache.items()}
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == dtype
    assert cache["k"].any()
    path = str(tmp_path / "kv.npz")
    tck.save_params(path, cache)
    for back in (tck.load_params(path), jck.load_params(path)):
        for key in ("k", "v", "k_scale", "v_scale", "pos", "table"):
            assert _bits(back[key]) == _bits(cache[key]), key


_Pair = collections.namedtuple("_Pair", "a b")


def _crafted(path, skeleton, version=2):
    np.savez(path, arr_0=np.zeros(2, np.float32),
             __skeleton__=np.frombuffer(json.dumps(skeleton).encode(), np.uint8),
             __manifest__=np.frombuffer(json.dumps(
                 {"version": version, "leaves": [{"dtype": "float32"}]}).encode(), np.uint8))
    return path


REFUSALS = {
    "int_key": ("save", {1: np.zeros(2)}),
    "mixed_keys": ("save", {"a": np.zeros(2), 2: np.ones(2)}),
    "namedtuple": ("save", {"p": _Pair(np.zeros(2), np.ones(2))}),
    "ordered_dict": ("save", collections.OrderedDict(a=np.zeros(2))),
    "version": ("load", {"t": "dict", "items": {"w": None}}),
    "unknown_kind": ("load", {"t": "set", "items": [None]}),
    "missing_file": ("load", None),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_every_refusal_raises_the_jax_exception_type(tmp_path, case):
    op, arg = REFUSALS[case]
    if op == "save":
        calls = [lambda mod: mod.save_params(str(tmp_path / "x.npz"), arg)]
    else:
        path = str(tmp_path / "absent.npz")
        if arg is not None:
            path = _crafted(path, arg, version=3 if case == "version" else 2)
        calls = [lambda mod: mod.load_params(path)]
    raised = []
    for mod in (jck, tck):
        with pytest.raises(Exception) as info:
            calls[0](mod)
        raised.append(type(info.value))
    assert raised[0] is raised[1], raised
    assert not list(tmp_path.glob("*.tmp"))  # nothing half-written stays


def _zoo_vars(family):
    """A seeded port module of ``family`` as flax variables (a FrozenDict,
    as an older flax's ``init`` returns), checked against the shapes of
    flax's own ``init`` (traced, not run)."""
    cfg = registry.resolve_family_config(family, "tiny")
    module = registry.get_family(family).init_params(cfg, torch.Generator().manual_seed(3),
                                                     dtype=None, device="cpu")
    variables = jax.tree.map(lambda t: t.numpy(), zoo_to_flax(family, module))
    fam = jax_registry.get_family(family)
    shapes = jax.eval_shape(lambda k: fam.init_params(k, jax_registry.resolve_config(
        family, "tiny")), jax.random.PRNGKey(0))
    assert jax.tree.map(np.shape, variables) == jax.tree.map(lambda a: a.shape,
                                                             unfreeze(shapes))
    return freeze(variables)


def _rows(family):
    rng = np.random.default_rng(5)
    cfg = registry.resolve_family_config(family, "tiny")
    if family == "bert":
        x = rng.integers(1, cfg.vocab_size, size=(3, 16)).astype(np.int32)
        x[:, 10:] = cfg.pad_id
        return x
    x = registry.example_input(family, cfg, 3)
    return rng.normal(size=x.shape).astype(np.float32)


@pytest.mark.parametrize("family", ["mlp", "cnn", "resnet", "bert"])
def test_zoo_checkpoints_serve_across_the_packages(tmp_path, family):
    variables = _zoo_vars(family)
    jm = jax_registry.build_compiled(family, preset="tiny", params=variables)
    jpath = str(tmp_path / "jax.npz")
    jm.save_checkpoint(jpath)
    x = _rows(family)
    want = np.asarray(jm(x), np.float32)
    comp = create_builtin(Implementation.JAX_MODEL, {
        "family": family, "preset": "tiny", "checkpoint": jpath, "batching": False,
        "buckets": "4"}, device="cpu")
    got = comp.model(x)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.log(got), np.log(want), atol=LOG_TOL)
    # the port's file serves in the JAX package with the JAX predictions
    ppath = str(tmp_path / "port.npz")
    comp.model.save_checkpoint(ppath)
    back = jck.load_params(ppath)
    jback = jax_registry.build_compiled(family, preset="tiny", params=back)
    np.testing.assert_array_equal(np.asarray(jback(x)), np.asarray(jm(x)))
    same = jax.tree.map(lambda a, b: np.array_equal(np.asarray(a), np.asarray(b)),
                        back, unfreeze(variables))
    assert all(jax.tree.leaves(same))


@pytest.fixture(scope="module")
def heads_file(tiny, tmp_path_factory):
    cfg, jparams, _ = tiny
    path = str(tmp_path_factory.mktemp("heads") / "heads.npz")
    jck.save_params(path, jax.device_get(
        jl.init_medusa_heads(jax.random.PRNGKey(1), cfg, 3, base_head=jparams["head"])))
    return path


def test_trained_heads_serve_the_jax_tokens_and_ledger(tiny, files, heads_file):
    cfg, jparams, tcfg = tiny
    kw = dict(n_slots=4, decode_block=4, spec_draft=3, spec_method="heads",
              spec_heads_path=heads_file)
    wave = PROMPTS + [REPETITIVE]

    def serve(model, cls):
        async def go():
            sched = cls(model)
            try:
                return [o.tolist() for o in await asyncio.gather(*(
                    sched.submit(np.asarray(p, np.int32), max_new_tokens=11) for p in wave))]
            finally:
                await sched.close()

        return asyncio.run(go())

    jm = JaxGenerativeModel(cfg, jparams, **kw)
    want = serve(jm, JaxScheduler)
    tm = GenerativeModel(tcfg, params_from_jax(files["float32"][0], tcfg), seq_impl="dense",
                         device="cpu", **kw)
    assert tm.spec_heads == 3 and tm.spec_heads_path == heads_file
    assert serve(tm, GenerationScheduler) == want
    ledger = (tm.spec_emitted_tokens, tm.spec_verify_passes)
    assert ledger == (jm.spec_emitted_tokens, jm.spec_verify_passes)
    assert ledger[0] > ledger[1] > 0  # some drafts were accepted


def _bad_heads(cfg, case):
    rng = np.random.default_rng(0)
    E, V = cfg.hidden, cfg.vocab_size

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "no_head": {"w1": n(3, E, E)},
        "k_mismatch": {"w1": n(3, E, E), "head": n(4, E, V)},
        "k_below_draft": {"w1": n(2, E, E), "head": n(2, E, V)},
        "wrong_vocab": {"w1": n(3, E, E), "head": n(3, E, V + 1)},
        "wrong_width": {"w1": n(3, E + 1, E + 1), "head": n(3, E + 1, V)},
        "a_list": [n(3, E, E), n(3, E, V)],
    }[case]


@pytest.mark.parametrize("case", ["no_head", "k_mismatch", "k_below_draft", "wrong_vocab",
                                  "wrong_width", "a_list", "unreadable"])
def test_a_malformed_heads_file_is_refused_by_name(tiny, files, tmp_path, case):
    tcfg = tiny[2]
    path = str(tmp_path / "heads.npz")
    if case == "unreadable":
        path = str(tmp_path / "absent" / "heads.npz")
    else:
        tck.save_params(path, _bad_heads(tcfg, case))
    with pytest.raises(GraphUnitError, match="Medusa checkpoint .*heads.npz"):
        GenerativeModel(tcfg, params_from_jax(files["float32"][0], tcfg), n_slots=2,
                        decode_block=4, spec_draft=3, spec_method="heads",
                        spec_heads_path=path, device="cpu")


def test_mesh_still_raises_by_name():
    assert registry.LATER_SLICE_PARAMS == ("mesh",)
    from seldon_core_tpu_torch.graph.units import MODEL_LATER_PARAMS

    assert MODEL_LATER_PARAMS == ("mesh",)
    with pytest.raises(GraphUnitError, match="mesh"):
        create_builtin(Implementation.JAX_GENERATIVE, {"preset": "tiny", "mesh": "auto"},
                       device="cpu")
    with pytest.raises(GraphUnitError, match="mesh"):
        create_builtin(Implementation.JAX_MODEL, {"family": "mlp", "preset": "tiny",
                                                  "mesh": "auto"}, device="cpu")
