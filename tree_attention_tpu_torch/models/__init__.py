"""The transformer LM, its KV-cache decoding, and its training step."""

from tree_attention_tpu_torch.models.decode import (  # noqa: F401
    KVCache,
    PagedKVCache,
    PagedQuantKVCache,
    QuantKVCache,
    compact_decode_window,
    decode_attention,
    fold_in,
    forward_step,
    generate,
    init_cache,
    init_paged_cache,
    paged_insert_slot,
    quantize_cache,
    quantize_paged_blocks,
    round_cache_len,
    sample_rows,
    sample_slots,
)
from tree_attention_tpu_torch.models.train import (  # noqa: F401
    OptimizerSpec,
    TrainState,
    default_optimizer,
    init_train_state,
    loss_and_grads,
    make_train_step,
    params_digest,
    shard_batch,
)
from tree_attention_tpu_torch.models.transformer import (  # noqa: F401
    TransformerConfig,
    count_params,
    cross_entropy_loss,
    forward,
    init_params,
    loss_fn,
    named_params,
    params_from_jax,
)
