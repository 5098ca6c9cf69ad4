"""The transformer LM and its KV-cache decoding."""

from tree_attention_tpu_torch.models.decode import (  # noqa: F401
    KVCache,
    PagedKVCache,
    decode_attention,
    forward_step,
    generate,
    init_cache,
    init_paged_cache,
    round_cache_len,
    sample_slots,
)
from tree_attention_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    forward,
    init_params,
    params_from_jax,
)
