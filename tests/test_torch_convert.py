"""HF Llama conversion in the port against the JAX package's and against
transformers, on the CPU, with a tiny randomly initialized HF Llama built
locally (nothing is downloaded).

* The port's ``params_from_hf_state_dict`` gives the JAX conversion's
  arrays, equal bit for bit, and the same ``Config``; with tied
  embeddings too.
* The port's model built from them gives transformers' logits (GQA: 4
  query heads over 2 KV heads) within ``HF_TOL``, and greedy decoding
  through the port's scheduler gives transformers' tokens.
* ``rope_scaling``, an explicit ``head_dim`` that differs and projection
  biases (``attention_bias``) are refused as in the JAX package; plain
  RoPE spelled ``{"rope_type": "default"}`` (newer transformers releases)
  is accepted with its ``rope_theta``, where the JAX converter refuses it.
* ``convert_hf_llama`` on a ``save_pretrained`` directory writes an npz
  that the JAX package's ``load_params`` reads equal to its own
  conversion, and the CLI writes the same file.
"""

import asyncio
import os

import numpy as np
import pytest

# transformers would also import TensorFlow where it is installed; nothing
# here uses it, and it takes seconds
os.environ.setdefault("USE_TF", "0")
torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from seldon_core_tpu.executor.checkpoint import load_params as jax_load_params  # noqa: E402
from seldon_core_tpu.models import convert as jconvert  # noqa: E402
from seldon_core_tpu_torch.executor.generation import (  # noqa: E402
    GenerationScheduler,
    GenerativeModel,
)
from seldon_core_tpu_torch.models import convert  # noqa: E402
from seldon_core_tpu_torch.models.weights import params_from_jax  # noqa: E402

HF_TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_convert.py's, against transformers
TOKS = [5, 9, 2, 17, 3, 42, 8, 1]


def _hf_config(**kw):
    base = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
                rope_theta=10000.0, rms_norm_eps=1e-5, attention_bias=False,
                tie_word_embeddings=False)
    base.update(kw)
    return transformers.LlamaConfig(**base)


@pytest.fixture(scope="module")
def hf():
    cfg = _hf_config()
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval(), cfg


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    out.update({f"layers/{k}": v for k, v in tree["layers"].items()})
    return out


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_arrays_equal_the_jax_conversion(hf, tied):
    model, hf_cfg = hf
    state = model.state_dict()
    if tied:
        state = {k: v for k, v in state.items() if k != "lm_head.weight"}
    cfg = convert.config_from_hf(hf_cfg)
    jcfg = jconvert.config_from_hf(hf_cfg)
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == {
        f: getattr(jcfg, f) for f in cfg.__dataclass_fields__}
    got = _flat(convert.params_from_hf_state_dict(state, cfg))
    want = _flat(jconvert.params_from_hf_state_dict(state, jcfg))
    assert got.keys() == want.keys()
    for key, arr in got.items():
        assert arr.dtype == want[key].dtype and arr.tobytes() == want[key].tobytes(), key
    if tied:
        np.testing.assert_array_equal(got["head"], got["tok_emb"].T)


def test_logits_and_greedy_tokens_equal_transformers(hf):
    model, hf_cfg = hf
    cfg = convert.config_from_hf(hf_cfg)
    assert (cfg.n_heads, cfg.n_kv_heads) == (4, 2)  # GQA
    params = params_from_jax(convert.params_from_hf_state_dict(model.state_dict(), cfg), cfg)
    toks = torch.tensor([TOKS])
    with torch.no_grad():
        want = model(toks).logits.numpy()
        got = params(toks.to(torch.int32), seq_impl="dense").numpy()
    np.testing.assert_allclose(got, want, **HF_TOL)
    # greedy through the port's scheduler against transformers' argmax loop
    hf_toks = TOKS[:5]
    for _ in range(6):
        with torch.no_grad():
            hf_toks.append(int(model(torch.tensor([hf_toks])).logits[0, -1].argmax()))
    gm = GenerativeModel(cfg, params, n_slots=1, decode_block=4, seq_impl="dense", device="cpu")

    async def serve():
        sched = GenerationScheduler(gm)
        try:
            return (await sched.submit(np.asarray(TOKS[:5], np.int32), max_new_tokens=6)).tolist()
        finally:
            await sched.close()

    assert TOKS[:5] + asyncio.run(serve()) == hf_toks


def test_unsupported_variants_are_refused():
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        convert.config_from_hf(_hf_config(rope_scaling={"rope_type": "linear", "factor": 2.0}))
    with pytest.raises(NotImplementedError, match="head_dim"):
        convert.config_from_hf(_hf_config(head_dim=32))
    cfg = _hf_config(num_hidden_layers=1, attention_bias=True)
    torch.manual_seed(0)
    state = transformers.LlamaForCausalLM(cfg).state_dict()
    for mod in (convert, jconvert):
        with pytest.raises(NotImplementedError, match="no serving counterpart"):
            mod.params_from_hf_state_dict(state, mod.config_from_hf(cfg))


def test_plain_rope_written_as_a_type_is_accepted():
    # newer transformers releases write every Llama config's plain RoPE as
    # {"rope_type": "default", "rope_theta": ...}; the JAX converter takes
    # any rope_scaling for a scaling and refuses it (ROADMAP Queue C)
    cfg = _hf_config(rope_scaling={"rope_type": "default", "rope_theta": 500000.0})
    assert convert.config_from_hf(cfg).rope_theta == 500000.0
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        jconvert.config_from_hf(cfg)
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        convert.config_from_hf(_hf_config(rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                                        "low_freq_factor": 1.0,
                                                        "high_freq_factor": 4.0,
                                                        "original_max_position_embeddings": 64}))


def test_convert_hf_llama_writes_what_jax_reads(hf, tmp_path):
    model, hf_cfg = hf
    model.save_pretrained(tmp_path / "hf")
    out = str(tmp_path / "port.npz")
    cfg = convert.convert_hf_llama(str(tmp_path / "hf"), out)
    assert cfg.n_layers == 2 and cfg.vocab_size == 128
    want = _flat(jconvert.params_from_hf_state_dict(model.state_dict(),
                                                    jconvert.config_from_hf(hf_cfg)))
    back = _flat(jax_load_params(out))
    assert back.keys() == want.keys()
    for key, arr in back.items():
        assert arr.dtype == want[key].dtype and arr.tobytes() == want[key].tobytes(), key
    cli = str(tmp_path / "cli.npz")
    convert.main([str(tmp_path / "hf"), cli])
    for key, arr in _flat(jax_load_params(cli)).items():
        assert arr.tobytes() == want[key].tobytes(), key
