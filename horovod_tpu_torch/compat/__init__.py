"""Checkpoint interop: load external pretrained weights into the port's
model and export them back (`compat.hf.from_hf_gpt2` / `from_hf_llama`
/ `from_hf_mistral` / `from_hf_qwen2` / `from_hf_gemma`, and
`from_hf_state_dict` without `transformers`; `to_hf_gpt2` /
`to_hf_llama` / `to_hf_gemma`), and the JAX package's trained state
(`compat.from_jax`)."""

from horovod_tpu_torch.compat.hf import (from_hf_gemma, from_hf_gpt2,
                                         from_hf_llama, from_hf_mistral,
                                         from_hf_qwen2, from_hf_state_dict,
                                         to_hf_gemma, to_hf_gpt2,
                                         to_hf_llama)

__all__ = ["from_hf_gemma", "from_hf_gpt2", "from_hf_llama",
           "from_hf_mistral", "from_hf_qwen2", "from_hf_state_dict",
           "to_hf_gemma", "to_hf_gpt2", "to_hf_llama"]
