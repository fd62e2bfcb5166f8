"""Checkpoint conversion: Hugging Face Llama weights -> serving params.

The port's copy of the JAX package's ``models/convert.py``.  It maps a HF
``LlamaForCausalLM`` state dict onto the JAX package's stacked-layer
layout (``models/llama.py`` ``param_shapes``: one array per parameter with
a leading layers axis) and writes the pickle-free npz of
``executor/checkpoint.py``, so the two packages' conversions of one HF
model give equal arrays and either package serves the file:

    python -m seldon_core_tpu_torch.models.convert /path/to/hf-llama out.npz

HF checkpoints use the same rotate-half RoPE as the serving forward, so
weights map by transpose and reshape only.  Conversion is offline CPU
work: ``transformers`` is imported inside :func:`convert_hf_llama` only,
and a model variant the serving forward does not implement (RoPE scaling,
an explicit ``head_dim`` other than ``hidden // n_heads``, any tensor left
over, such as projection biases) is refused rather than written.  Plain
RoPE written as ``{"rope_type": "default"}``, as newer ``transformers``
releases write every Llama config, is accepted (the JAX package's
converter refuses it).
"""

from __future__ import annotations

import argparse
from typing import Any

import numpy as np

from seldon_core_tpu_torch.models.llama import Config


def _rope_theta(hf_config: Any) -> float:
    """The config's RoPE base.  Newer ``transformers`` releases spell plain
    RoPE as ``rope_scaling``/``rope_parameters`` ``{"rope_type":
    "default", "rope_theta": ...}``; any other type (linear, dynamic,
    yarn, llama3, ...) is a scaling the serving RoPE does not implement."""
    theta = getattr(hf_config, "rope_theta", None)
    for name in ("rope_scaling", "rope_parameters"):
        rope = getattr(hf_config, name, None)
        if not rope:
            continue
        kind = rope.get("rope_type", rope.get("type")) if isinstance(rope, dict) else rope
        if kind != "default":
            raise NotImplementedError(
                f"{name}={rope!r} is not implemented by the serving "
                "RoPE (models/llama.py uses plain theta); converting "
                "would produce wrong logits for every position"
            )
        theta = rope.get("rope_theta", theta)
    return float(10000.0 if theta is None else theta)


def config_from_hf(hf_config: Any) -> Config:
    """A HF ``LlamaConfig`` -> the serving :class:`Config`; raises
    ``NotImplementedError`` for the variants the forward lacks."""
    rope_theta = _rope_theta(hf_config)
    derived_hd = hf_config.hidden_size // hf_config.num_attention_heads
    explicit_hd = getattr(hf_config, "head_dim", None)
    if explicit_hd is not None and explicit_hd != derived_hd:
        raise NotImplementedError(
            f"head_dim={explicit_hd} differs from hidden//n_heads="
            f"{derived_hd}; the serving config derives head_dim and cannot "
            "represent this model"
        )
    return Config(
        vocab_size=hf_config.vocab_size,
        hidden=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads", hf_config.num_attention_heads),
        ffn=hf_config.intermediate_size,
        max_seq=min(hf_config.max_position_embeddings, 8192),
        rope_theta=rope_theta,
        norm_eps=getattr(hf_config, "rms_norm_eps", 1e-5),
    )


def params_from_hf_state_dict(state: dict, cfg: Config) -> dict:
    """HF ``LlamaForCausalLM`` tensors -> the stacked float32 param tree.

    A ``Linear`` stores ``(out, in)``; the serving contractions take
    ``(in, ...out)``, hence the transposes."""
    consumed: set[str] = set()

    def t(name: str) -> np.ndarray:
        consumed.add(name)
        tensor = state[name]
        arr = tensor.detach().cpu().float().numpy() if hasattr(tensor, "detach") else np.asarray(
            tensor)
        return np.ascontiguousarray(arr, dtype=np.float32)

    H, nh, nkv, hd = cfg.hidden, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    layer_specs = {
        "wq": lambda p: t(p + "self_attn.q_proj.weight").T.reshape(H, nh, hd),
        "wk": lambda p: t(p + "self_attn.k_proj.weight").T.reshape(H, nkv, hd),
        "wv": lambda p: t(p + "self_attn.v_proj.weight").T.reshape(H, nkv, hd),
        "wo": lambda p: t(p + "self_attn.o_proj.weight").T.reshape(nh, hd, H),
        "w_gate": lambda p: t(p + "mlp.gate_proj.weight").T,
        "w_up": lambda p: t(p + "mlp.up_proj.weight").T,
        "w_down": lambda p: t(p + "mlp.down_proj.weight").T,
        "ln_att": lambda p: t(p + "input_layernorm.weight"),
        "ln_mlp": lambda p: t(p + "post_attention_layernorm.weight"),
    }
    # one parameter stacked at a time: the peak holds the torch model plus
    # ONE stacked array's per-layer copies
    layers: dict[str, np.ndarray] = {}
    for key, fn in layer_specs.items():
        per_layer = [fn(f"model.layers.{i}.") for i in range(cfg.n_layers)]
        layers[key] = np.stack(per_layer)
        per_layer.clear()
    tok_emb = t("model.embed_tokens.weight")
    if "lm_head.weight" in state:
        head = t("lm_head.weight").T
    else:  # tied embeddings
        head = tok_emb.T.copy()
    params = {"tok_emb": tok_emb, "layers": layers, "ln_f": t("model.norm.weight"),
              "head": head}
    # every remaining tensor is a weight the serving forward would ignore
    leftovers = {k for k in state if k not in consumed and "rotary_emb" not in k}
    if leftovers:
        sample = ", ".join(sorted(leftovers)[:5])
        raise NotImplementedError(
            f"{len(leftovers)} state-dict tensors have no serving "
            f"counterpart (e.g. {sample}); this model variant is not "
            "supported — refusing to write a checkpoint that would serve "
            "wrong logits"
        )
    return params


def convert_hf_llama(model_path: str, out_path: str) -> Config:
    """Load a local HF Llama directory (safetensors/bin) on the CPU and
    write the serving npz; returns its config."""
    from transformers import AutoConfig, AutoModelForCausalLM

    from seldon_core_tpu_torch.executor.checkpoint import save_params

    hf_config = AutoConfig.from_pretrained(model_path)
    cfg = config_from_hf(hf_config)  # refuses before the weights are read
    # no dtype argument: its name differs across transformers releases;
    # params_from_hf_state_dict widens whatever loads to float32
    model = AutoModelForCausalLM.from_pretrained(model_path)
    params = params_from_hf_state_dict(model.state_dict(), cfg)
    del model  # the torch copy goes before the npz write doubles buffers
    save_params(out_path, params)
    return cfg


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="HF Llama -> serving npz")
    parser.add_argument("model_path", help="HF model directory")
    parser.add_argument("out_path", help="npz checkpoint to write")
    args = parser.parse_args(argv)
    cfg = convert_hf_llama(args.model_path, args.out_path)
    print(
        f"wrote {args.out_path}: {cfg.n_layers} layers, hidden {cfg.hidden}, "
        f"vocab {cfg.vocab_size}.  Serve with JAX_GENERATIVE parameters "
        f'{{"checkpoint": "{args.out_path}", ...}} matching this config.'
    )


if __name__ == "__main__":
    main()
