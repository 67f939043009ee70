"""HuggingFace checkpoint import and export — five decoder families onto
the port's `TransformerLM`.

Counterpart of `horovod_tpu.compat.hf`. A `transformers` GPT-2, LLaMA,
Mistral, Qwen2 or Gemma-1 model loads into the flagship `TransformerLM`
(weights included), so the port's kernels, KV-cache `generate`, paged
serving and int8 serving apply to real pretrained weights; the
``to_hf_*`` exporters write a port model back into an HF model shell.

The mapping reads only the HF ``config`` and the named weights, so its
core is one function on (config mapping, state dict with HF key names),
`from_hf_state_dict`; the public ``from_hf_*`` take the HF model, as
the JAX package's do, and call it with ``config.to_dict()`` and
``state_dict()``. A caller without `transformers` (the card machine)
calls `from_hf_state_dict` directly. Nothing here imports
`transformers`.

Weight map (HF names without their ``transformer.`` / ``model.``
prefix; torch ``nn.Linear`` stores [out, in], the port's kernels are
[in, out], so LLaMA-family kernels are transposed while GPT-2's Conv1D
[in, out] maps as it is):

    GPT-2:  wte -> embed (tied head), wpe -> pos, h.i.ln_1 / ln_2 ->
            blocks.i.ln_attn / ln_mlp, h.i.attn.c_attn / c_proj ->
            blocks.i.attn.qkv / out, h.i.mlp.c_fc / c_proj ->
            blocks.i.mlp.wi / wo, ln_f -> ln_f
    LLaMA:  embed_tokens -> embed, layers.i.self_attn.{q,k,v}_proj ->
            blocks.i.attn.qkv (q|k|v concatenated on out, K/V at
            kv-head width: GQA), o_proj -> attn.out, mlp.{gate,up,down}
            _proj -> mlp.{gate,up,down}, input_layernorm /
            post_attention_layernorm -> ln_attn / ln_mlp (RMSNorm
            scales), norm -> ln_f, lm_head -> lm_head (untied)

Mistral is the LLaMA map with the config's sliding window on
``window``; Qwen2 adds q/k/v biases (detected from the weights);
Gemma-1 adds GeGLU, the sqrt(hidden) input scale and RMSNorm's (1 + w)
folded into the scales. Each family rejects what the JAX package
rejects, with its messages.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from horovod_tpu_torch.models.transformer import LLAMA_ARCH_KW, TransformerLM

FAMILIES = ("gpt2", "llama", "mistral", "qwen2", "gemma")


def _t(x) -> torch.Tensor:
    """A weight as a float32 tensor on its own device (numpy arrays: on
    the CPU)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.detach().float()


def _strip(state_dict: Mapping) -> Dict[str, Any]:
    """HF key names without the base model's prefix (a ``*LMHeadModel``
    / ``*ForCausalLM`` nests the base model under ``transformer.`` or
    ``model.``; the base model itself has none)."""
    out = {}
    for k, v in state_dict.items():
        for pre in ("transformer.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
                break
        out[k] = v
    return out


def from_hf_state_dict(family: str, config: Mapping, state_dict: Mapping,
                       *, dtype=torch.bfloat16, attn_impl: str = "flash",
                       device=None, **model_kw) -> TransformerLM:
    """A port `TransformerLM` of ``family`` (one of `FAMILIES`) built
    from an HF config mapping (``config.to_dict()``, or a dict of the
    same keys) and a state dict with HF key names (tensors or numpy
    arrays, on any device; the ``transformer.`` / ``model.`` prefix is
    optional), on ``device`` (default ``"cuda"``), weights loaded.
    ``dtype`` is the compute dtype (parameters stay float32, as the
    model keeps them; `serving_params` casts for serving).
    ``model_kw`` passes other `TransformerLM` fields, for example
    ``decode_prefix_impl="pallas"``, which sends every decode tick to
    the flash-decode kernel."""
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, got "
                         f"{family!r}")
    if model_kw.get("moe_every", 0):
        raise ValueError(
            f"{family} checkpoints are dense: HF import of a "
            f"mixture-of-experts family (Mixtral, Qwen2-MoE) is in "
            f"neither package")
    cfg = dict(config)
    sd = _strip(state_dict)
    kw = dict(dtype=dtype, attn_impl=attn_impl, device=device, **model_kw)
    if family == "gpt2":
        model, weights = _gpt2(cfg, sd, kw)
    elif family == "gemma":
        model, weights = _gemma(cfg, sd, kw)
    else:
        window = cfg.get("sliding_window")
        if family == "qwen2":
            if cfg.get("use_sliding_window", False):
                raise ValueError(
                    "use_sliding_window=True is per-layer "
                    "(max_window_layers) in Qwen2 and is not supported")
            # Qwen2's config may carry a sliding_window value even when
            # unused: override rather than read it.
            window = None
        model, weights = _llama(cfg, sd, kw, window)
    with torch.no_grad():
        model.load_state_dict(weights)
    return model


def _gpt2(cfg, sd, kw):
    d = cfg["n_embd"]
    H = cfg["n_head"]
    if d % H:
        raise ValueError(f"n_embd={d} not divisible by n_head={H}")
    # Only the tanh-approximate GELUs match the port's gelu; HF's plain
    # "gelu" is the EXACT erf form, whose per-activation delta (~4e-4)
    # compounds across layers and breaks the parity guarantee.
    act = cfg.get("activation_function", "gelu_new")
    if act not in ("gelu_new", "gelu_pytorch_tanh"):
        raise ValueError(
            f"unsupported activation {act!r} (only the tanh-approximate "
            "gelu_new family converts with exact parity)")
    n_inner = cfg.get("n_inner")
    inner = n_inner if n_inner is not None else 4 * d
    if inner % d:
        raise ValueError(
            f"n_inner={inner} not a multiple of n_embd={d} "
            "(TransformerLM's MLP width is mlp_ratio * d)")
    for knob, want in (("scale_attn_weights", True),
                       ("scale_attn_by_inverse_layer_idx", False),
                       ("reorder_and_upcast_attn", False),
                       ("add_cross_attention", False)):
        if cfg.get(knob, want) != want:
            raise ValueError(
                f"unsupported GPT2Config: {knob}={cfg.get(knob)!r} "
                f"(mapping implements {knob}={want})")
    model = TransformerLM(
        cfg["vocab_size"], cfg["n_layer"], H, d // H,
        max_len=cfg["n_positions"], pos_emb="learned",
        mlp_ratio=inner // d, attn_bias=True,
        ln_eps=float(cfg["layer_norm_epsilon"]), **kw)
    w = {"embed": _t(sd["wte.weight"]), "pos": _t(sd["wpe.weight"]),
         "ln_f.scale": _t(sd["ln_f.weight"]),
         "ln_f.bias": _t(sd["ln_f.bias"])}
    for i in range(cfg["n_layer"]):
        h, b = f"h.{i}.", f"blocks.{i}."
        for hf, ours in (("ln_1", "ln_attn"), ("ln_2", "ln_mlp")):
            w[b + ours + ".scale"] = _t(sd[h + hf + ".weight"])
            w[b + ours + ".bias"] = _t(sd[h + hf + ".bias"])
        for hf, ours in (("attn.c_attn", "attn.qkv"),
                         ("attn.c_proj", "attn.out"),
                         ("mlp.c_fc", "mlp.wi"), ("mlp.c_proj", "mlp.wo")):
            w[b + ours + ".kernel"] = _t(sd[h + hf + ".weight"])
            w[b + ours + ".bias"] = _t(sd[h + hf + ".bias"])
    return model, w


def _llama_family_blocks(sd, n_layers: int, *, qkv_bias: bool = False,
                         fold_norm=None) -> Dict[str, torch.Tensor]:
    """The per-layer weight map every LLaMA-lattice family shares
    (llama / mistral / qwen2 / gemma): q|k|v concatenated at kv-head
    width, o_proj, gate/up/down, pre/post RMSNorm scales. ``fold_norm``
    maps an HF norm weight to the port's scale (default `_t`; Gemma
    folds its (1 + w) here). One site, so a layout change cannot be
    mirrored into one family member and missed in another."""
    fold = fold_norm or _t
    w: Dict[str, torch.Tensor] = {}
    for i in range(n_layers):
        h, b = f"layers.{i}.", f"blocks.{i}."
        sa = h + "self_attn."
        w[b + "attn.qkv.kernel"] = torch.cat(
            [_t(sd[sa + f"{p}_proj.weight"]).T for p in "qkv"], dim=1)
        if qkv_bias:
            w[b + "attn.qkv.bias"] = torch.cat(
                [_t(sd[sa + f"{p}_proj.bias"]) for p in "qkv"])
        w[b + "attn.out.kernel"] = _t(sd[sa + "o_proj.weight"]).T
        w[b + "ln_attn.scale"] = fold(sd[h + "input_layernorm.weight"])
        w[b + "ln_mlp.scale"] = fold(
            sd[h + "post_attention_layernorm.weight"])
        for p in ("gate", "up", "down"):
            w[b + f"mlp.{p}.kernel"] = _t(sd[h + f"mlp.{p}_proj.weight"]).T
    return {k: v.contiguous() for k, v in w.items()}


def _llama(cfg, sd, kw, window):
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    Hkv = cfg.get("num_key_value_heads") or H
    if d % H:
        raise ValueError(f"hidden_size={d} not divisible by heads={H}")
    act = cfg.get("hidden_act", "silu")
    if act != "silu":
        raise ValueError(f"unsupported hidden_act {act!r} (silu only)")
    if cfg.get("rope_scaling"):
        raise ValueError("rope_scaling is not supported")
    if cfg.get("mlp_bias", False):
        raise ValueError("mlp_bias checkpoints are not supported")
    # Qwen2-style qkv biases are supported (bias on q/k/v, none on
    # o_proj); detect from the weights rather than config-flag names,
    # which differ across the family (attention_bias vs qkv_bias).
    qkv_bias = "layers.0.self_attn.q_proj.bias" in sd
    if "layers.0.self_attn.o_proj.bias" in sd:
        raise ValueError("o_proj bias is not supported")
    head_dim = cfg.get("head_dim") or d // H
    if head_dim != d // H:
        raise ValueError(
            f"head_dim={head_dim} != hidden_size/heads={d // H}")
    tied = bool(cfg.get("tie_word_embeddings", False))
    # Mistral = the LLaMA mapping + sliding-window attention (``window``
    # from its config); the band semantics match (keep i - j < window).
    n = cfg["num_hidden_layers"]
    model = TransformerLM(
        cfg["vocab_size"], n, H, head_dim, num_kv_heads=Hkv,
        max_len=cfg["max_position_embeddings"], pos_emb="rope",
        rope_theta=float(cfg["rope_theta"]), window=window,
        mlp_hidden=cfg["intermediate_size"],
        ln_eps=float(cfg["rms_norm_eps"]), attn_bias=qkv_bias,
        attn_out_bias=False, **dict(LLAMA_ARCH_KW, tied_head=tied), **kw)
    w = {"embed": _t(sd["embed_tokens.weight"]),
         "ln_f.scale": _t(sd["norm.weight"])}
    if not tied:
        w["lm_head"] = _t(sd["lm_head.weight"])
    w.update(_llama_family_blocks(sd, n, qkv_bias=qkv_bias))
    return model, w


def _gemma(cfg, sd, kw):
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    Hkv = cfg.get("num_key_value_heads") or H
    _gemma_act_check(cfg)
    head_dim = cfg.get("head_dim") or d // H
    if head_dim != d // H:
        raise ValueError(
            f"head_dim={head_dim} != hidden_size/heads={d // H} "
            f"(Gemma-7B's widened heads need an out-projection shape "
            f"our attention block does not carry)")
    if not bool(cfg.get("tie_word_embeddings", True)):
        raise ValueError("Gemma ties the LM head; untied is not a "
                         "Gemma-1 checkpoint")
    if ("layers.0.self_attn.q_proj.bias" in sd
            or "layers.0.self_attn.o_proj.bias" in sd):
        raise ValueError("attention biases are not Gemma-1")
    n = cfg["num_hidden_layers"]
    model = TransformerLM(
        cfg["vocab_size"], n, H, head_dim, num_kv_heads=Hkv,
        max_len=cfg["max_position_embeddings"], pos_emb="rope",
        rope_theta=float(cfg["rope_theta"]),
        mlp_hidden=cfg["intermediate_size"], norm="rmsnorm",
        mlp_impl="geglu", tied_head=True, embed_scale=float(d) ** 0.5,
        ln_eps=float(cfg["rms_norm_eps"]), **kw)

    def fold_gemma(x):
        return _t(x) + 1.0     # Gemma: x_norm * (1 + w)

    w = {"embed": _t(sd["embed_tokens.weight"]),
         "ln_f.scale": fold_gemma(sd["norm.weight"])}
    w.update(_llama_family_blocks(sd, n, fold_norm=fold_gemma))
    return model, w


def _gemma_act_check(cfg) -> None:
    """transformers' GemmaMLP builds act_fn from ``hidden_act``; some
    configs ALSO carry ``hidden_activation``. Both, when present, must
    be the tanh approximation — checking only the unused field would
    silently accept a checkpoint torch runs with exact erf-gelu. One
    site for import AND export. ``cfg`` is a config mapping or an HF
    config object."""
    get = cfg.get if isinstance(cfg, Mapping) else (
        lambda name: getattr(cfg, name, None))
    acts = {name: a for name in ("hidden_act", "hidden_activation")
            if (a := get(name)) is not None}
    bad = {n: a for n, a in acts.items() if a != "gelu_pytorch_tanh"}
    if bad or not acts:
        raise ValueError(
            f"unsupported activation {bad or acts} "
            f"(gelu_pytorch_tanh only — exact-gelu checkpoints would "
            f"silently drift)")


def _from_hf(family, hf_model, dtype, attn_impl, device):
    return from_hf_state_dict(family, hf_model.config.to_dict(),
                              hf_model.state_dict(), dtype=dtype,
                              attn_impl=attn_impl, device=device)


def from_hf_gpt2(hf_model: Any, *, dtype=torch.bfloat16,
                 attn_impl: str = "flash", device=None) -> TransformerLM:
    """A `transformers.GPT2LMHeadModel` (or `GPT2Model`) as a port
    `TransformerLM` on ``device`` (default ``"cuda"``): learned
    positions, LayerNorm, tanh-gelu MLP, projection biases, tied head.
    Pass ``dtype=torch.float32`` for logit parity with the HF model."""
    return _from_hf("gpt2", hf_model, dtype, attn_impl, device)


def from_hf_llama(hf_model: Any, *, dtype=torch.bfloat16,
                  attn_impl: str = "flash", device=None) -> TransformerLM:
    """A `transformers.LlamaForCausalLM`: RoPE, GQA (consumed natively
    by the flash kernels), RMSNorm, SwiGLU MLP, untied head (or tied,
    per the config). HF's rotary embedding is the half-split rotation
    at theta^(-2i/d), the port's `apply_rope`."""
    return _from_hf("llama", hf_model, dtype, attn_impl, device)


def from_hf_mistral(hf_model: Any, *, dtype=torch.bfloat16,
                    attn_impl: str = "flash", device=None) -> TransformerLM:
    """A `transformers.MistralForCausalLM`: the LLaMA map plus
    ``config.sliding_window`` on ``window`` (band rule i - j < window,
    HF's sliding mask; the decode cache becomes the rolling buffer)."""
    return _from_hf("mistral", hf_model, dtype, attn_impl, device)


def from_hf_qwen2(hf_model: Any, *, dtype=torch.bfloat16,
                  attn_impl: str = "flash", device=None) -> TransformerLM:
    """A `transformers.Qwen2ForCausalLM`: the LLaMA map plus q/k/v-only
    projection biases (``attn_bias=True, attn_out_bias=False``,
    detected from the weights). ``use_sliding_window=True`` (per-layer
    in Qwen2) is rejected: the port's ``window`` is uniform."""
    return _from_hf("qwen2", hf_model, dtype, attn_impl, device)


def from_hf_gemma(hf_model: Any, *, dtype=torch.bfloat16,
                  attn_impl: str = "flash", device=None) -> TransformerLM:
    """A `transformers.GemmaForCausalLM` (Gemma-1): the LLaMA lattice
    plus GeGLU (``mlp_impl="geglu"``, tanh-gelu gate), input embeddings
    scaled by sqrt(hidden) (``embed_scale``; the tied head reads the
    unscaled table) and RMSNorm's (1 + w) folded into the scales.
    Gemma-2 is another architecture and is not read."""
    return _from_hf("gemma", hf_model, dtype, attn_impl, device)


def _lin(t) -> torch.Tensor:
    """A weight as a contiguous CPU float32 tensor; ``copy_`` recasts
    it to the target parameter's dtype."""
    return _t(t).cpu().contiguous()


def to_hf_gpt2(model: TransformerLM, hf_model: Any) -> Any:
    """Write a GPT-2-layout port model (learned positions, LayerNorm,
    gelu MLP, biases, tied head) into a `transformers.GPT2LMHeadModel`
    shell of the same architecture; its weights are overwritten in
    place and the shell is returned."""
    sd = model.state_dict()
    tr = hf_model.transformer
    cfg = hf_model.config
    if (cfg.n_layer != model.num_layers
            or cfg.vocab_size != sd["embed"].shape[0]
            or cfg.n_embd != sd["embed"].shape[1]
            or cfg.n_positions != sd["pos"].shape[0]):
        raise ValueError(
            f"target GPT2 shell (layers={cfg.n_layer}, "
            f"vocab={cfg.vocab_size}, d={cfg.n_embd}, "
            f"pos={cfg.n_positions}) does not match the model "
            f"(blocks={model.num_layers}, embed="
            f"{tuple(sd['embed'].shape)}, pos={sd['pos'].shape[0]}) — a "
            "mismatched shell would silently export a different model")
    with torch.no_grad():
        tr.wte.weight.copy_(_lin(sd["embed"]))
        tr.wpe.weight.copy_(_lin(sd["pos"]))
        tr.ln_f.weight.copy_(_lin(sd["ln_f.scale"]))
        tr.ln_f.bias.copy_(_lin(sd["ln_f.bias"]))
        for i, h in enumerate(tr.h):
            b = f"blocks.{i}."
            for mod, ours in ((h.ln_1, "ln_attn"), (h.ln_2, "ln_mlp")):
                mod.weight.copy_(_lin(sd[b + ours + ".scale"]))
                mod.bias.copy_(_lin(sd[b + ours + ".bias"]))
            for mod, ours in ((h.attn.c_attn, "attn.qkv"),
                              (h.attn.c_proj, "attn.out"),
                              (h.mlp.c_fc, "mlp.wi"),
                              (h.mlp.c_proj, "mlp.wo")):
                mod.weight.copy_(_lin(sd[b + ours + ".kernel"]))
                mod.bias.copy_(_lin(sd[b + ours + ".bias"]))
        hf_model.lm_head.weight.copy_(_lin(sd["embed"]))   # tied
    return hf_model


def to_hf_llama(model: TransformerLM, hf_model: Any) -> Any:
    """Write a LLaMA-layout port model (RMSNorm, SwiGLU, RoPE, GQA, q/k/v
    biases or none) into a `transformers.LlamaForCausalLM` /
    `MistralForCausalLM` / `Qwen2ForCausalLM` shell — the inverse of
    `from_hf_llama` (torch Linear wants [out, in]: transposes)."""
    return _to_hf_llama(model, hf_model, unfold=None)


def _to_hf_llama(model, hf_model, unfold):
    tr = hf_model.model
    cfg = hf_model.config
    sd = model.state_dict()
    d = model.num_heads * model.head_dim
    kvd = model.num_kv * model.head_dim
    mismatches = []
    if cfg.num_hidden_layers != model.num_layers:
        mismatches.append(
            f"layers {cfg.num_hidden_layers} != {model.num_layers}")
    if cfg.vocab_size != sd["embed"].shape[0]:
        mismatches.append(
            f"vocab {cfg.vocab_size} != {sd['embed'].shape[0]}")
    if cfg.hidden_size != d:
        mismatches.append(f"hidden {cfg.hidden_size} != {d}")
    if bool(getattr(cfg, "tie_word_embeddings", False)) != bool(
            model.tied_head):
        mismatches.append(
            f"tie_word_embeddings {cfg.tie_word_embeddings} != "
            f"tied_head {model.tied_head}")
    for knob, mine in (("rope_theta", model.rope_theta),
                       ("rms_norm_eps", model.ln_eps)):
        if abs(float(getattr(cfg, knob)) - float(mine)) > 1e-12:
            mismatches.append(f"{knob} {getattr(cfg, knob)} != {mine}")
    if getattr(cfg, "sliding_window", None) != model.window:
        mismatches.append(
            f"sliding_window {getattr(cfg, 'sliding_window', None)} "
            f"!= window {model.window}")
    model_has_bias = "blocks.0.attn.qkv.bias" in sd
    shell_has_bias = tr.layers[0].self_attn.q_proj.bias is not None
    if model_has_bias != shell_has_bias:
        mismatches.append(f"qkv bias: model {model_has_bias} != shell "
                          f"{shell_has_bias}")
    if mismatches:
        raise ValueError(
            "target shell does not match the source model — a "
            "mismatched shell would silently export a different "
            "model: " + "; ".join(mismatches))
    fold = unfold or _lin
    with torch.no_grad():
        tr.embed_tokens.weight.copy_(_lin(sd["embed"]))
        tr.norm.weight.copy_(fold(sd["ln_f.scale"]))
        if not model.tied_head:
            hf_model.lm_head.weight.copy_(_lin(sd["lm_head"]))
        for i, layer in enumerate(tr.layers):
            b = f"blocks.{i}."
            sa = layer.self_attn
            qkv = _lin(sd[b + "attn.qkv.kernel"])
            sa.q_proj.weight.copy_(qkv[:, :d].T)
            sa.k_proj.weight.copy_(qkv[:, d:d + kvd].T)
            sa.v_proj.weight.copy_(qkv[:, d + kvd:].T)
            if model_has_bias:
                qb = _lin(sd[b + "attn.qkv.bias"])
                sa.q_proj.bias.copy_(qb[:d])
                sa.k_proj.bias.copy_(qb[d:d + kvd])
                sa.v_proj.bias.copy_(qb[d + kvd:])
            sa.o_proj.weight.copy_(_lin(sd[b + "attn.out.kernel"]).T)
            layer.input_layernorm.weight.copy_(fold(sd[b + "ln_attn.scale"]))
            layer.post_attention_layernorm.weight.copy_(
                fold(sd[b + "ln_mlp.scale"]))
            for p in ("gate", "up", "down"):
                getattr(layer.mlp, f"{p}_proj").weight.copy_(
                    _lin(sd[b + f"mlp.{p}.kernel"]).T)
    return hf_model


def to_hf_gemma(model: TransformerLM, hf_model: Any) -> Any:
    """Write a Gemma-layout port model into a
    `transformers.GemmaForCausalLM` shell — the inverse of
    `from_hf_gemma`: the (1 + w) RMSNorm fold is inverted (w = scale -
    1) and the layout write is `to_hf_llama`'s (a Gemma shell carries
    the same LLaMA-family module names)."""
    if model.mlp_impl != "geglu" or model.embed_scale is None:
        raise ValueError(
            "to_hf_gemma wants a from_hf_gemma-shaped model "
            f"(mlp_impl='geglu' + embed_scale; got "
            f"{model.mlp_impl!r}, {model.embed_scale!r})")
    d = model.num_heads * model.head_dim
    if abs(float(model.embed_scale) - d ** 0.5) > 1e-6 * d ** 0.5:
        # torch's GemmaModel hardcodes normalizer = sqrt(hidden); any
        # other trained-in scale would export silently-different math.
        raise ValueError(
            f"embed_scale={model.embed_scale} != sqrt(hidden)="
            f"{d ** 0.5:.6f} — not exportable as a Gemma checkpoint")
    cfg = hf_model.config
    if getattr(cfg, "model_type", None) != "gemma":
        # A LLaMA-family shell has the same module NAMES but x*w
        # RMSNorm and no embedding normalizer — the unfolded scales
        # would load cleanly and run a different model.
        raise ValueError(
            f"target shell model_type={getattr(cfg, 'model_type', None)!r} "
            f"is not 'gemma'")
    _gemma_act_check(cfg)
    return _to_hf_llama(model, hf_model, unfold=lambda s: _lin(s) - 1.0)
