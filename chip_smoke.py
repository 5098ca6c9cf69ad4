"""On-card smoke test of the PyTorch + CUDA port (one NVIDIA H100).

Run from the root of a checkout: ``python3 chip_smoke.py`` (every phase),
or ``python3 chip_smoke.py --phases 3i`` (any list of the names of
:data:`PHASES`, comma- or space-separated: the build, then the named
phases with what they read of others — ``3b`` and ``3d`` run ``3``, ``7``
runs ``6`` — and the same last line; an unknown name fails). Phases, any
failure exits non-zero:

1. Build the CUDA kernels from ``tree_attention_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together), print the card, each
   kernel's registers and spills (the decode split body's tree variants
   beside their causal twins, every instantiation of the multi-row body of
   B1, B2, B4, B5 and the cast route, by library, and of the tick body),
   and the HGMMA instructions in the SASS of the tensor-core bodies of B3,
   B6 and B7 (``cuobjdump -sass``; none is a failure, and so is a spill in
   B7's tensor-core body, the multi-row decode body or the tick body).
2. Hold each kernel against its plain PyTorch version on the card at the
   main path's shapes (bf16; each query row's out within 2e-2 of that row's
   largest |out|, i.e. about two bf16 ulps, and lse within 1e-3 — P is
   rounded to bf16 on both sides; at the reference shape the gate is shown
   to reject an output halved and one split's keys dropped) and time kernel,
   plain
   version, and ``scaled_dot_product_attention`` on the same function as a
   yardstick (the port never calls it) — device time of each call's kernels
   from ``torch.profiler``, the larger of two traced runs (CUDA events if
   it traces nothing or reads below the bound), L2 flushed before each
   call — beside the least time the card could take (bytes /
   3.35 TB/s or FLOPs / 989 TFLOP/s, the larger); B1 and B4 at the
   reference workload also split body and merge apart. B3 also at the training
   shape (B2 H16 T4096 causal); at the serve-chunk shape the gate is shown
   to reject each row's causal frontier shifted by one key.
   Then the backward kernels B6 (dq) and B7 (dk, dv) against their plain
   versions at the training shape, a GQA shape with a query offset, a
   ragged Tq/Tk shape and a KV offset that is not tile-aligned (each row of
   each gradient within 2e-2 of that row's largest |plain value|, a dq row
   whose query sees exactly one key within the f32 rounding bound of its
   cancellation instead, their |d| printed beside it; at the training
   shape the gate is shown to reject dv halved, B7 skipping each KV tile's
   first live Q tile and B6's causal frontier shifted by one key), timed
   beside SDPA's backward (B7 in bf16 is its tensor-core body); then every
   body that ships off its tile edges (B3, B6, B7 in bf16 and f32, D 64
   and 128, Tq 5 and 130 against Tk 300, GQA, a negative and an unaligned
   offset, causal and not) under the same gates; and
   B3, B6, B7 timed at B1 H16 T16384 causal (no plain version there); and
   the gradients of the Tq < 128 training route (B1 forward, blockwise
   backward) against its plain forward, under the same row gate; and B6/B7
   with a non-zero lse cotangent at the training shape (``delta =
   rowsum(dO * O) - dlse``, as the tree merge gives them) against their
   plain versions, the one-key dq rows (``dlse K_0 scale`` now) held to the
   row gate plus their rounding bound, the gate shown rejecting ``dlse``
   left out of delta.
   The int8 routes under the same row gate: B4 at the reference workload
   and at GQA Hq32 Hkv8 Tq16 with per-batch offsets and a ragged Tk, B5 at
   the serve decode tick with per-block and with channel scales, B1 over
   int8 K/V (the cast route) at the reference workload and B2 over int8
   pools with per-block scales at the serve tick. Bound: the visible int8
   K+V bytes (plus Q, scales, output) / 3.35 TB/s, or the products at the
   int8 (q8q q.k) and bf16 rates; no PyTorch call computes int8-KV
   attention, so SDPA over the dequantized bf16 K/V is timed as a labelled
   yardstick. At B5's serve shape the gate is shown to reject per-block
   scales read by logical block, the V scalar applied before the softmax
   sum, and an output halved; the same at B2's cast tick.
   The tick body (B2, its cast route and B5 at one packed row through a
   table; ``cuda_decode.decode_body`` "tick"): every such call counted on
   the wrapper's ``.tick_launches``; under the row gate and timed beside
   its bound at D 64 and 128 over 64- and 16-token blocks (8 slots x 16
   heads of at most 640 tokens, ragged, one slot with no visible key), and
   at one long paged slot (B1 H16, 1000 blocks of 64: the reference
   workload through a table; bf16 and B5); bit for bit: NaN keys past each
   slot's frontier inside its last block, NaN blocks past each slot and
   in blocks no table names, and (int8) codes changed and NaN scalars past
   each slot, all unread; the gate shown rejecting the last cluster rank's
   partial left out of the merge.
   B2 with ``local_blocks`` (one rank's slice of a sequence-sharded pool
   under a signed table) at the serve tick (B8 H16 Tq1, 640-token slots)
   and a 64-row chunk, exact bf16 and int8 with per-block scales, over 80
   blocks sharded W = 2 and 4 ways with tables drawn as
   ``ShardedBlockAllocator`` hands blocks out: every rank's call under the
   row gate, rank 0's timed against its bound (the keys it holds / 3.35
   TB/s), the W partials merged by the in-process monoid against unsharded
   B2, an all-remote row exactly ``(0, -inf)`` (tick and chunk), each
   tick's rank pool past every frontier poisoned and unread bit for bit,
   and the gate shown rejecting remote entries read as block 0.
   Per-shard ``tree_decode`` at the reference workload: B1 over W = 2 and 4
   KV shards with their offsets, and B4 over the shards of the
   channel-quantized K/V, merged against the unsharded B1 / B4 under the
   same gate. The tree variants (speculative tree verification: the
   ancestor-window rule in place of the causal one) under the same row
   gate, masks random draft trees packed as ``pack_proposal`` packs them
   (one slot a chain):
   B2 and B5 at a verify tick (B8 H16, Tq 8 and 32 — bit 31 — 640-token
   slots, one window across a block boundary; bf16, int8 per-block
   scales), B1 and B4 at the contiguous verify tick and at the reference
   workload with Tq 8, the int8-cast routes of B1 and B2; each timed beside
   its bound (the keys some row sees, K+V / 3.35 TB/s) and SDPA with a
   boolean ``attn_mask`` over the gathered view. A lower-triangular mask
   gives the causal launch's out and lse bit for bit (B1, B2, B4, B5);
   table entries past each window named a NaN block change nothing; the
   gate is shown rejecting each row reading the previous row's bits and
   the window shifted by one key.
   B2's multi-row body (bf16, more than one packed row: prompt tails,
   verify ticks, the sharded pool's chunks; ``cuda_decode.decode_body``)
   under the row gate at Tq 2, 8, 28, 32, 64, 127 for G 1 and 4, ragged
   640-token slots, every table entry past each window naming a NaN block,
   and under ``local_blocks`` with every block the rank's table does not
   name NaN-poisoned; each such launch counted on ``.tiled_launches``; the
   prompt-tail buckets Tq 8, 16, 32, 64 timed beside SDPA.
   B1 and B5 on the same multi-row body (exact bf16 contiguous, and paged
   int8 x int8, with more than one packed row or a tree), each launch
   counted on the wrapper's ``.tiled_launches``: B1 under the row gate at
   GQA Tq 16 over Tk 4096 and 4037, Tq 2, 5, 64, 127, G 1 and 4, D 64 and
   128, causal with per-slot kv_offset (a shard wholly past its frontier
   exactly ``(0, -inf)``) and not causal, K/V past each frontier NaN
   unread bit for bit, the gate shown rejecting an output halved and the
   first split's keys left out; B5 at chain and tree verify ticks (Tq 8,
   32) over 64- and 16-token blocks with per-block scales that differ by
   block and with channel scales, every Q and K code at +-127, tril ==
   causal and NaN blocks and scales past each window unread bit for bit,
   the gate shown rejecting scales read by logical block, the V scalar
   before the softmax sum and an output halved; B5's chain verify ticks
   timed.
   B4 and the int8 cast route over B1/B2 on the same multi-row body (phase
   2g), each launch counted on ``.tiled_launches`` (B4) or
   ``.cast_tiled_launches`` (B1, B2): B4 under the row gate at GQA Tq 16
   over Tk 4096 and 4037, Tq 2, 5, 64, 127, G 1 and 4, D 64 and 128,
   causal with per-slot kv_offset (a shard past its frontier exactly
   ``(0, -inf)``) and not, trees at Tq 8 and 32 and at the reference
   workload; the cast route on both layouts with channel scales and with
   per-block scales over 64- and 16-token blocks, trees at Tq 8 and 32,
   the ``local_blocks`` 64-row chunk at W 2 and 4 merged against
   unsharded B2, codes at +-127; bit for bit: tril == causal, codes past
   each frontier changed, and NaN scalars past each window and in every
   block a rank's table does not name, all unread; the gate shown
   rejecting an output halved, one split dropped, scalars read by logical
   block and the V scalar before the softmax sum; the timed cases beside
   their bound and the dequantized-SDPA yardstick.
3. Serve 16 requests through the paged, chunked SlotServer (the CLI's
   ``--mode serve`` entry point) at the reference attention width (d_model
   2048, 16 heads x 128, d_ff 5504, vocab 32768, bf16, depth cut to 4
   layers, random weights from a seed); check every request retires with
   its budget, the pool drains, the paged decode (B2: every one-row tick
   on its tick body, its multi-row body on the prompt-tail ticks, counted
   by Tq bucket) and Q-tiled (B3) kernels ran, and one mixed step's
   logits and written KV match the plain path on the same cache (logits
   within 0.1: bf16 activations, relative precision ~4e-3, through 4 layers
   at a logit scale ~1; KV within 2e-2 of the pool's largest |value|). The
   serve step's device time is split by kernel group from a traced wave,
   against the same wave's untraced wall.
   Then int8: 16 requests through ``cli.main --mode serve --kv-quant
   int8`` (staged admission, the paged int8 cache): every request retires
   with its budget, the pool drains, B5 launched once per layer and int8
   step, each on its tick body, B1/B3 for the staged chunks (the tails
   below 128 rows on B1's multi-row body); 4 requests on the contiguous int8
   cache (B4 once per layer and int8 step) and 4 through ``--kv-quant
   int8-cast`` (B2 with per-block scales once per layer and int8 step,
   on its tick body);
   the 8-request wave again on an
   int8 cache, its device time split (B5 apart) and its greedy tokens
   against the exact wave's (reported); and one int8 decode step, kernel
   path against plain path on clones of one per-block-quantized cache, for
   both q8 routes (logits within 0.1, block scales equal, written codes
   equal in layer 0 and within 2 codes beyond it; the code gate shown
   rejecting new rows quantized under the next head's block scale). The
   int8 serves run with the metrics registry off, as the exact serve does;
   their int8 steps are the report's decode ticks (one step over the int8
   cache each).
   Then speculative serving (``--speculate``, draft_k 4): the 16-request
   serve through ``cli.run_serve`` with ``--drafter ngram`` and
   ``ngram-tree``, exact and ``--kv-quant int8``, and the 8-request wave
   with an oracle drafter (the non-speculative wave's tokens, a wrong token
   every 3rd call, a decoy branch packed before the true chain: every
   proposal a tree, every commit a compaction) on the paged and contiguous
   layouts, exact and int8: every request retires with its budget, the
   pool drains, each tree verify tick launches the layout's tree kernel
   once per layer and no other tree kernel runs (through the multi-row
   body of B2, B1, B5 and B4, which every verify tick takes), and the
   same oracle wave through the int8 cast route (``quant_kernel="q8"``)
   on the paged and contiguous layouts, whose verify ticks take the cast
   route's multi-row body (B2 with per-block scales, B1); the
   oracle's acceptance
   is above 0 on the paged layouts, and every emitted greedy token is
   within 0.1 of its position's largest logit when the stream is re-scored
   by the non-speculative kernel path through the serve's own q8 route
   (teacher-forced replay). One tree
   verify step's logits against the plain path (exact and int8) and
   against each root path decoded one token at a time, within 0.1. Token
   agreement with the non-speculative serve, acceptance, tokens per verify
   tick and spec tok/s beside non-spec tok/s are reported, with the oracle
   wave's device split, exact and on the paged and contiguous int8 pools.
   Every serve's launches of the multi-row body are reported by kernel and
   Tq. Then the radix prefix cache (``--prefix-cache --prefix-share 0.75
   --prefix-len 384`` on the serve phase's trace): exact, ``--kv-quant
   int8`` and ``int8-cast`` on the paged layout (hits share pool blocks;
   int8 hits dequantize them into the staging cache) and exact on the
   contiguous one (8 requests on 4 slots; hits gather from the cache's
   pool), each beside the same trace with the cache off: every request
   retires with its budget, hits happen and ``tokens_reused`` is the
   requests' ``prefix_hit_tokens`` (whole blocks, at most the prefix's),
   the pool drains to tree-owned blocks, the prompt tokens computed are
   the prompts less their matched tokens, every block the paged index
   adopted holds the bytes it held at adoption (an exact hit moves none),
   the one-row paged ticks run on the tick body, every emitted greedy
   token is within 0.1 of its position's largest logit on the cache-off
   path (teacher-forced replay), and that gate is shown rejecting a hit
   whose table row names the wrong shared blocks and an int8 hit whose
   dequantized prefix was dropped; TTFT, tok/s and prefill tokens with
   the cache on and off, and one traced serve's device split, are
   reported. Then two ranks on the one card (spawned processes on ``cuda:0`` over
   gloo; NCCL refuses two ranks on one device): ``--mesh seq=2 --kv-shard
   seq`` at the same width, exact and ``--kv-quant int8`` (16 requests
   each): every request retires with its budget, each rank's pool drains
   and holds half the whole pool's bytes, B2 ``local_blocks`` launches
   once per layer and step on each rank (nothing else reads the sharded
   pool; the exact chunks take its multi-row body, every tick its tick
   body; the int8 slice runs one-row decode ticks only, staged admission's
   chunks going to the staging cache), exactly 1 MAX + 2 SUM all-reduces
   per layer and step (int8: plus one SUM per step for the anchor scales),
   both ranks' tokens equal; one mixed step's merged logits within 0.1 of
   the single-rank path on the same logical cache; greedy agreement with
   the single-rank serve reported; and ``--mode decode --mesh seq=2`` at
   the reference workload
   (its time: two ranks sharing one card, not a scaling figure).
   Then sequence-parallel training on two ranks sharing the card (the same
   spawning, over gloo): ``tree_attention`` alone at B2 H16 T4096 D128
   causal bf16 in the contiguous and zigzag layouts, each rank's out/lse
   against the rows of the unsharded B3 under the row gate and its
   dq/dk/dv under a random ``dout`` and non-zero ``dlse`` against the rows
   of the unsharded B6/B7 under the gradient gate plus the rounding the
   merge adds (each partial's output cotangent cast to bf16:
   ``cuda_bwd.merge_cotangent_allowance``, six standard deviations; the
   row gate alone is printed beside it), the gates shown
   rejecting each rank's reduce-scatter returning the previous rank's rows
   and the lse cotangent dropped; then ``cli.main`` with ``TRAIN_ARGS``
   (2 steps, then 1 + 1 timed) ``--mesh seq=2 --dist-backend gloo`` in both
   layouts: finite losses, the ranks' parameters equal (digest), per rank
   B3 twice and B6/B7 once per layer, step and attended (query block, key
   block) pair (``tree_runs``), no B1, per layer and step 3 all-gathers, 2
   MAX and 3 reduce-scatters (forward, its recomputation, backward) and
   one gradient all-reduce per step; the first loss within 1e-2 of phase
   5's (same seed and batch); one zigzag step's wall and rank 0's device
   time by kernel group. Their times: two ranks sharing one card, not a
   scaling figure.
   Then live HTTP serving (phase 3g, after phase 7: ``ingress_phase``):
   the serve phase's engine behind an ``IngressServer`` on 127.0.0.1 port
   0, ``--max-queue 4``, clients on ``http.client`` in threads of this
   process: the 16 prompts at once (8 over SSE, 8 whole bodies, each
   honouring 429's Retry-After), a client gone after its 4th token, a
   deadline passed on arrival and one that expires in flight, a burst of
   12 past the queue bound, ``POST /admin/drain`` (202), a POST after it
   (503) and ``join()``; then ``--kv-quant int8`` with a prompt cancelled
   after its first staged chunk and a client gone after its 2nd token.
   Gates: every result within 0.1 of its positions' largest logits
   (teacher-forced replay), SSE streams and whole bodies equal to their
   results, the scripted outcomes, the drained pools leak-free, B2's tick
   body and B3 (B5's under int8) launched, and the gates shown rejecting a
   cancel that leaks its blocks and one streamed token swapped; client
   TTFT and TBT p50/p95, tokens/s, status counts and the phase's wall are
   printed beside the card's name and power limit. The telemetry plane
   rides that phase: the trace served statically unarmed then armed (the
   registry, the flight ring and a ``MetricsHTTPServer``; 4 requests of it
   under int8), gated on equal tokens, launches and host reads of the card
   (one fetch per tick that paid one), tok/s of both printed; the exact
   HTTP serve armed, its endpoint scraped mid-serve (``/healthz`` 200
   ``ok``, ``/metrics``, ``/slots``) and after the drain (``/healthz``
   ``idle``, ``/flight``, ``/metrics`` = ``/metrics.json``), its records
   gated against its report (ticks recorded = executed, tokens emitted,
   the pool's blocks, each sweep arc = its outcomes); a callback wedging a
   tick past ``stall_after`` must read 503 ``stalled`` and a raising tick
   must leave an ``engine_error`` dump of the ticks before it.
   Then whole-prompt admission and the host-RAM KV tier (phase 3h, after
   3g: ``whole_tier_phase``). (a) The serve phase's trace with
   ``--admission whole``: exact paged, ``--kv-quant int8`` paged (B5
   ticks), exact contiguous (8 requests on 4 slots, B1 ticks), exact paged
   with ``--prefix-cache --prefix-share 0.75 --prefix-len 384`` (hits run
   their suffix as one-slot steps) and with ``--speculate --drafter
   ngram``, beside the chunked serve of the same trace run first in the
   phase: every request retires with its budget, the pools drain, the
   replay gate, B3 once per layer per cold admission at Tq = Tk = the
   prompt's bucket (512 or 640) and no prompt chunk without the cache, the
   one-row paged ticks on the tick body; a traced 8-request wave of each
   admission with its D2H copies against its ticks (whole: at most one a
   tick); a lone 512-token request's TTFT, whole and chunked; the gate
   shown rejecting an insert one block off in the slot's table row. (b)
   ``--prefix-cache --host-blocks 64`` on a 34-block pool with 2 slots,
   exact and int8: 8 prompts on 8 distinct 384-token prefixes cold, then
   the same prefixes with new suffixes: pass 1 demotes, every pass-2
   request hits its whole prefix and restores happen, every adopted block
   holds its adoption bytes (and scales) wherever it lives now, the replay
   gate, the pools drain with nothing staged; the same trace with
   ``--kv-tiering off`` and with a pool that keeps everything (pass-2
   TTFT), a third pass traced (the tier's D2H and H2D copies, GB/s, the
   idle share), the pinned bytes; the bytes gate shown rejecting a restore
   that scatters its host rows in reverse order (the replay gate cannot
   see a permutation of visible blocks) and both gates one that skips its
   scatter.
   Then copy-on-write fork families (phase 3i, after 3h: ``fork_phase``)
   on the serve phase's engine and prompts (one cut to whole blocks): 4
   requests with ``n = 2`` against the same prompts as 8 independent
   requests (each branch's tokens equal its twins', the replay gate, the
   prompt tokens computed halved, the peak blocks down by exactly the
   shared ancestors, one tail copy per unaligned prompt and none for the
   aligned one), 2 families under ``--kv-quant int8`` against their int8
   twins, 2 sampled ``n = 4`` families (a second serve bit-identical,
   branch 0 the ``n = 1`` stream, the branches not all equal),
   ``best_of = 4`` (one finish, the winner), ``fork_at = 16``, one ``n =
   3`` SSE request through an ``IngressServer`` equal to the engine's own
   serve of the seed, a cancel before the fork and one mid-family, a
   family on a radix hit; under every serve the ownership gate (no block
   outside the shared state in two tables) and the bytes gate (every
   shared ancestor's bytes unchanged from its fork to the family's last
   retire), the pool drained with no shared block; the gates shown
   rejecting a skipped tail copy, a child table naming the parent's tail
   block and a tail block shared by refcount. Phase 3c's two ranks also
   serve one ``n = 2`` family on the sharded pool: its branches equal its
   independent twins on the same ranks, the ranks agree, and its
   agreement with the single-rank family is printed. Phase 3i's engines run
   the fork-slot path (``tree_sampling`` off).
   Then token-tree sibling families (phase 3j: ``tree_phase``): ``n = 4``
   with 8 new tokens and ``n = 8`` with 4 on the serve's prompts, greedy,
   exact and int8, each in ONE slot (the fork-slot path: one a branch),
   the replay gate, B2's (B5's) ``tree`` variant once per layer per tree
   tick; ``n = 8`` on a one-slot engine; sampled families on short prompts
   held by the logit gate (every row that drew a branch's token against
   the teacher-forced replay of the branch's tokens), a
   second serve bit-identical, and an ``n = 2`` family whose branch 0 stops
   on an EOS so the survivor at rank 1 is compacted and decodes on; the
   gate shown rejecting a mask that lets branches see their siblings' rows
   and a collapse that skips the compaction. Then disaggregated serving
   (phase 3k: ``disagg_phase``): the 16-request trace through
   ``--serve-disagg --prefill-slots 2``, exact and int8, against the fused
   serve (tokens, or the replay gate where they part), both workers on one
   pool (``data_ptr``), every handoff naming the same block ids with the
   allocator's counts unchanged and no device kernel or copy traced, the
   decode worker at Tq 1, ``blocks_transferred`` equal to the handed-off
   private blocks, the pool drained; the gates shown rejecting a handoff
   that copies the blocks into a second pool and one that reserves again
   instead of transferring. The exact pair serve runs with the flight ring
   armed: every record tagged ``prefill`` or ``decode``, one of each per
   executed tick, and the decode records' tokens plus each request's first
   (sampled by the prefill worker) the report's; and with the request
   ledger armed: every request's ledger charges ``handoff_s > 0`` and
   reconciles, the report's aggregates are its ledgers'; a ledger that
   drops ``park`` is shown rejected. Phase 3g's static A/B serves arm the
   ledger with the flight ring: launches, host reads and tokens equal
   armed and unarmed, the armed report's aggregates ``aggregate_ledgers``
   of its results, the unarmed one's empty.
   Then the in-process fleet (phase 3l: ``fleet_phase``): two
   ``LocalReplica`` engines from one ``cli.engine_factory`` (one copy of
   the parameters on the card, a block pool each) behind a
   ``FleetRouter`` with the prefix cache and the request ledger on: 16
   requests (4 shared 384-token prefixes, 4 tails each, 32 new tokens,
   greedy) one at a time through the router, then the same requests on two
   fresh engines without it, each serving its replica's requests one after
   the other: tokens and B2/B3 launches per replica equal; every repeat
   of a prefix on its first's replica with the whole prefix hit (the
   router's affinity count and the replicas' ``ServeReport.prefix``
   agree); every ledger reconciled; the router's ``/requests`` every uid
   once with its replica's label, the telemetry endpoint's
   ``/request/{uid}`` the same ledger; a rolling restart under 8 cold
   concurrent requests dropping nothing, both drains leak-free; a router
   that ignores affinity shown rejected; then 2 prefixes x 2 under
   ``--kv-quant int8`` (B5) against their direct twins the same way; then
   ``cli.main --serve-fleet --replicas 2 --prefix-cache`` on the card's
   default device, 4 requests, SIGTERM: its record (the card, 2 affinity
   routes, clean leaks) and ``/requests``.
4. Time ``--mode decode`` at the reference workload (B=1, 16 heads x 128,
   64000 KV tokens, one query) through the contiguous decode kernel (B1),
   and with ``--kv-quant int8`` (B4) and ``int8-cast`` (B1 over int8 K/V);
   each step's median at or above its KV bytes / 3.35 TB/s.
5. Train through the CLI's ``--mode train`` (``cli.main`` in process) at
   the serve phase's model (T 4096, B 2, 4 steps, then 1 + 3 timed): every
   loss finite, and B6/B7 launched exactly once per layer per step, B3
   twice (forward and its recomputation under remat).
6. One step's gradients at depth 2, kernel path against plain path on the
   same parameters and batch: every parameter's |g_kernel - g_plain| /
   |g_plain| within 2e-2, the losses within 1e-2.
7. Split one training step's device time by kernel group from a traced
   step, against the median wall of three untraced steps (the idle share),
   with the steps' peak device memory.
8. Print each phase's wall as it ends (``phase <name> wall <s>``), the
   total wall, the kernels line, then ``{"ok": true, "device":
   {...}}`` last.

Extra per-case numbers go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time
import types

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12    # H100 SXM dense int8 tensor-core peak
TOL_OUT_REL, TOL_LSE = 2e-2, 1e-3  # out: relative to each row's max |out|
TOL_LOGITS = 0.1
TOL_KV_REL = 2e-2  # written KV: relative to the pool's max |value|
# Written int8 codes of one step, kernel path vs plain path: equal in layer
# 0 (same inputs), and beyond it, where the bf16 activations entering a
# layer differ by the previous layers' attention rounding, within the
# written-KV gate above in codes: 2e-2 of a block's 127-code range, 2 codes.
TOL_CODES = int(TOL_KV_REL * 127)
# dq/dk/dv: each row within 2e-2 of that row's largest |plain value| (about
# two bf16 ulps: both sides round ds and p to bf16 before the products).
# A dq row whose query sees exactly one key is 0 by cancellation (p = 1 and
# O = V there, so dO.V^T - delta = 0) and holds only f32 rounding, which two
# correct summation orders do not share: those rows alone are held to the
# rounding bound of cuda_bwd.dq_one_key_bound instead. The rule lives in
# cuda_bwd.grad_rows_close, which the GPU tests hold too.
TOL_GRAD_REL = 2e-2
# One training step, kernel path vs plain path: per-parameter gradient norm
# ratio, and the loss.
TOL_STEP_GRAD, TOL_STEP_LOSS = 2e-2, 1e-2
SERVE_ARGS = [
    "--mode", "serve", "--model-dim", "2048", "--heads", "16",
    "--n-layers", "4", "--vocab-size", "32768", "--dtype", "bfloat16",
    "--slots", "8", "--requests", "16", "--prompt-len", "512",
    "--prompt-jitter", "64", "--max-new-tokens", "64",
    "--prefill-chunk", "256", "--kv-layout", "paged", "--kv-block", "64",
    "--temperature", "0",
]
TRAIN_ARGS = [
    "--mode", "train", "--model-dim", "2048", "--heads", "16",
    "--n-layers", "4", "--vocab-size", "32768", "--seq-len", "4096",
    "--batch", "2", "--steps", "4", "--dtype", "bfloat16", "--iters", "3",
]


def causal_pairs(B: int, Hq: int, Tq: int, Tk: int, q_offset: int,
                 kv_offset: int) -> int:
    """Visible (query, key) pairs of causal attention with scalar offsets,
    summed over batch rows and query heads."""
    return B * Hq * sum(min(Tk, max(0, q_offset + i - kv_offset + 1))
                        for i in range(Tq))


def _fwd_bwd_name(m) -> str:
    dtype = "f32" if m.group(2) == "f" else "bf16"
    return f"{m.group(1)}<{dtype},{m.group(3)}>"


def ptxas_summary(build, libs=("flash_fwd", "flash_bwd"),
                  pattern=r"(flash_(?:fwd|dq|dkv)(?:_wgmma)?_kernel)I"
                          r"(13__nv_bfloat16|f|)Li(\d+)E",
                  name=_fwd_bwd_name) -> dict:
    """``{kernel: [registers, spill-store bytes]}`` from the ``-Xptxas -v``
    log the build keeps beside each library of ``libs``: every entry
    function whose mangled name matches ``pattern``, named by ``name(match)``.
    The default reads the forward and backward kernels (B3, B6, B7) as
    ``kernel<dtype,D>``; the tensor-core bodies are bf16 only
    (``*_wgmma_kernel<D>``)."""
    import re

    out = {}
    for lib in libs:
        log = build._target(lib).with_suffix(".log").read_text()
        for block in log.split("Compiling entry function")[1:]:
            m = re.search(pattern, block)
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            if m and regs:
                out[name(m)] = [int(regs.group(1)),
                                int(spill.group(1)) if spill else 0]
    return out


def hgmma_counts(build) -> dict:
    """``{mangled kernel name: HGMMA instructions}`` of the tensor-core
    bodies (``*_wgmma_kernel``) in the built B3 and B6 libraries, from the
    toolkit's ``cuobjdump -sass``: the proof that their products run on
    the tensor cores."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for lib in ("flash_fwd", "flash_bwd"):
        sass = subprocess.run([tool, "-sass", str(build._target(lib))],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
        for block in sass.split("Function : ")[1:]:
            name = block.split(None, 1)[0]
            if "wgmma_kernel" in name:
                out[name] = sum("HGMMA" in line
                                for line in block.splitlines())
    return out


def rows_close(a, b):
    """Hold ``a = (out, lse)`` against the plain ``b``: every query row's
    |dout| within TOL_OUT_REL of that row's largest plain |out| (an empty
    row must be exactly 0 on both sides), the same empty rows, |dlse|
    within TOL_LSE. Returns ``(ok, |dout|, relative |dout|, |dlse|)``."""
    import torch

    (o1, l1), (o2, l2) = a, b
    if not (torch.isfinite(o1).all() and o1.shape == o2.shape):
        return False, math.inf, math.inf, math.inf
    d = (o1.float() - o2.float()).abs()
    row = o2.float().abs().amax(-1, keepdim=True)
    rel = (d / row.clamp_min(1e-30)).max().item()
    fin = torch.isfinite(l2)
    el = (l1[fin] - l2[fin]).abs().max().item() if fin.any() else 0.0
    ok = (torch.equal(torch.isneginf(l1), torch.isneginf(l2))
          and rel <= TOL_OUT_REL and el <= TOL_LSE)
    return ok, d.max().item(), rel, el


MESH_ARGS = ["--mesh", "seq=2", "--dist-backend", "gloo"]
DECODE_MESH_ARGS = ["--mode", "decode", "--iters", "20"]
SHARDED_TIMEOUT_S = 600


def _sharded_rank(rank: int, world: int, port: int, device: str,
                  serve_args: list, decode_args: list) -> dict:
    """One rank of the two-rank phase: the sharded serve exact and int8
    through ``cli.run_serve`` (what ``cli.main`` runs once the group
    forms), one mixed step against the single-rank path on the same
    logical cache, and ``cli.main --mode decode`` on the mesh. ``device``
    "cpu" with small arguments rehearses it without the card."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.models import (
        forward_step,
        init_paged_cache,
    )
    from tree_attention_tpu_torch.ops import cuda_attention, cuda_decode
    from tree_attention_tpu_torch.parallel import (
        COLLECTIVES,
        initialize_distributed,
        make_mesh,
    )
    from tree_attention_tpu_torch.serving import (
        Request,
        ShardedBlockAllocator,
        SlotServer,
        synthetic_trace,
    )
    from tree_attention_tpu_torch.utils.config import parse_args

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, created = initialize_distributed("gloo", device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    mesh = make_mesh({"seq": world})
    b2 = cuda_decode.attention_cuda_decode_paged
    counters = {
        "flash_decode": (cuda_decode.attention_cuda_decode, "launches"),
        "flash_decode_paged": (b2, "launches"),
        "flash_decode_paged_local": (b2, "local_launches"),
        "flash_decode_paged_tiled": (b2, "tiled_launches"),
        "flash_decode_paged_tick": (b2, "tick_launches"),
        "flash_decode_tiled": (cuda_decode.attention_cuda_decode,
                               "tiled_launches"),
        "flash_decode_paged_q8q": (
            cuda_decode.attention_cuda_decode_paged_q8q, "launches"),
        "flash_fwd": (cuda_attention.attention_cuda_fwd, "launches"),
    }
    out = {}
    try:
        for label, extra in (("exact", []), ("int8", ["--kv-quant", "int8"])):
            cfg = parse_args(serve_args + MESH_ARGS + ["--kv-shard", "seq"]
                             + extra)
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            c0 = dict(COLLECTIVES)
            t0 = time.monotonic()
            rec, server, rep = cli.run_serve(cfg, dev, mesh)
            sync()
            wall = time.monotonic() - t0
            tcfg = server.cfg
            elem = (1 if server.quantize
                    else torch.empty(0, dtype=tcfg.dtype).element_size())
            whole = (2 * tcfg.n_layers * server.kv_blocks * tcfg.n_kv_heads
                     * server.kv_block * tcfg.d_head * elem
                     + (2 * tcfg.n_layers * server.kv_blocks
                        * tcfg.n_kv_heads * 4 if server.quantize else 0))
            out[label] = {
                "rec": rec, "wall_s": wall,
                "launches": {n: getattr(fn, a)
                             for n, (fn, a) in counters.items()},
                "colls": {f"{a}/{c}": v - c0.get((a, c), 0)
                          for (a, c), v in COLLECTIVES.items()
                          if v - c0.get((a, c), 0)},
                "tokens": {r.uid: r.tokens for r in rep.results},
                "pool_bytes": server.pool_bytes(),
                "whole_pool_bytes": whole,
            }
            if label == "exact":
                params = server.params
                out["family"] = _sharded_family(
                    server, rank, cfg, Request, SlotServer, synthetic_trace,
                    COLLECTIVES, sync)
            del server
        # One mixed step on the same logical cache: the whole pool filled by
        # the single-rank path, this rank's slice copied out of it, then
        # decode rows, a 256-row chunk, a short chunk and an inert slot.
        B, nb, blk = 8, 10, 64
        npool = B * nb
        alloc = ShardedBlockAllocator(npool, world)
        alloc.reserve(npool)
        table = torch.tensor([[alloc.alloc() for _ in range(nb)]
                              for _ in range(B)], dtype=torch.int32,
                             device=dev)
        gen = torch.Generator(device=dev).manual_seed(1)
        pre = torch.randint(0, tcfg.vocab_size, (B, 256), generator=gen,
                            device=dev)
        toks = torch.randint(0, tcfg.vocab_size, (B, 256), generator=gen,
                             device=dev)
        n0 = torch.tensor([256, 17, 0, 200, 64, 1, 256, 128], device=dev,
                          dtype=torch.int32)
        n1 = torch.tensor([1, 1, 256, 40, 0, 1, 100, 1], device=dev,
                          dtype=torch.int32)
        whole = init_paged_cache(tcfg, B, nb * blk, npool, block=blk,
                                 device=dev)
        whole.table.copy_(table)
        _, whole = forward_step(params, pre, whole, tcfg, n_tokens=n0)
        kw = dict(mesh=mesh, kv_shard="seq")
        part = init_paged_cache(tcfg, B, nb * blk, npool, block=blk,
                                device=dev, **kw)
        nl = part.blocks
        lo = mesh.axis_index("seq") * nl
        part.k[:, :nl] = whole.k[:, lo:lo + nl]
        part.v[:, :nl] = whole.v[:, lo:lo + nl]
        part.table.copy_(table)
        part.length.copy_(whole.length)
        lg_sharded, _ = forward_step(params, toks, part, tcfg, n_tokens=n1,
                                     **kw)
        lg_single, _ = forward_step(params, toks, whole, tcfg, n_tokens=n1)
        valid = torch.arange(256, device=dev)[None] < n1[:, None]
        out["mixed"] = {"logits_err": (lg_sharded[valid] - lg_single[valid]
                                       ).abs().max().item()}
        del whole, part, params
        # The reference workload's decode on the mesh through cli.main (the
        # group exists, so main leaves it to this function).
        b1 = cuda_decode.attention_cuda_decode
        b1.launches = 0
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(decode_args + MESH_ARGS)
        sync()
        lines = buf.getvalue().strip().splitlines()
        out["decode"] = json.loads(lines[-1]) if rank == 0 else None
        out["decode_printed"] = bool(lines)
        out["decode_launches"] = b1.launches
    finally:
        if created:
            dist.destroy_process_group()
    return out


def _sharded_family(server, rank, cfg, Request, SlotServer, synthetic_trace,
                    collectives, sync) -> dict:
    """Phase 3c's fork family on the sharded pool: one ``n = 2`` request on
    the serve trace's first prompt (cut by a token if it ends on a block
    edge, so the fork copies a tail block), then the same prompt as two
    independent requests, on the same sharded engine; on rank 0 also the
    family on a single-rank engine over the same weights, and the replay
    margin (:func:`replay_margin`) of the sharded branches and twins on
    the single-rank kernel path. Returns the branches, the twins' tokens,
    the fork accounting, the SUMs the tail copy issued, the leak report
    (and on rank 0 the single-rank branches and the margin)."""
    prompt = synthetic_trace(
        1, prompt_len=cfg.prompt_len, prompt_jitter=cfg.prompt_jitter,
        max_new_tokens=cfg.max_new_tokens, vocab_size=server.cfg.vocab_size,
        seed=cfg.seed + 1)[0].prompt
    if len(prompt) % server.kv_block == 0:
        prompt = prompt[:-1]
    n_new = cfg.max_new_tokens
    c0 = collectives.get(("fork_copy", "psum"), 0)
    fam = server.serve([Request(uid=0, prompt=prompt, max_new_tokens=n_new,
                                n=2)])
    sync()
    copies = collectives.get(("fork_copy", "psum"), 0) - c0
    twins = server.serve([Request(uid=u, prompt=prompt,
                                  max_new_tokens=n_new) for u in (1, 2)])
    sync()
    out = {"branches": {r.index: list(map(int, r.tokens))
                        for r in fam.results},
           "twins": [list(map(int, r.tokens)) for r in twins.results],
           "kv": {k: fam.kv.get(k) for k in ("forks", "fork_blocks_shared")},
           "fork_copy_sums": copies, "leaks": server.leak_report(),
           "prompt_len": len(prompt), "n_new": n_new}
    if rank == 0:
        single = SlotServer(server.params, server.cfg, slots=server.slots,
                            cache_len=server.cache_len,
                            prefill_chunk=server.prefill_chunk,
                            kv_block=server.kv_block)
        rep = single.serve([Request(uid=0, prompt=prompt,
                                    max_new_tokens=n_new, n=2)])
        sync()
        out["single"] = {r.index: list(map(int, r.tokens))
                         for r in rep.results}
        del single
        results = list(fam.results) + list(twins.results)
        out["replay_margin"] = replay_margin(
            server.params, server.cfg, results,
            [Request(uid=r.uid, prompt=prompt, max_new_tokens=n_new)
             for r in results], False, "paged", server.device,
            server.kv_block)
    return out


def _rank_main(target, rank, world, port, out_q, *args) -> None:
    try:
        out_q.put((rank, True, target(rank, world, port, *args)))
    except BaseException:  # reported to the parent, which fails
        import traceback

        out_q.put((rank, False, traceback.format_exc()))


def run_ranks(target, world: int, *args, what: str = "sharded") -> list:
    """Spawn ``world`` ranks running ``target(rank, world, port, *args)``
    (each joins a gloo group on ``localhost:port``) and return their results
    in rank order; a rank that raises, dies or outlives
    ``SHARDED_TIMEOUT_S`` fails the script, and every rank still running
    is killed."""
    import multiprocessing
    import queue
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    out_q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, port, out_q, *args))
             for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + SHARDED_TIMEOUT_S
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                fail(f"{what} ranks did not finish within "
                     f"{SHARDED_TIMEOUT_S} s")
            try:
                rank, ok, payload = out_q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    fail(f"{what} ranks {dead} died")
                continue
            if not ok:
                fail(f"{what} rank {rank} raised:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                fail(f"a {what} rank exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [results[r] for r in range(world)]


def run_sharded_ranks(world: int = 2, device: str = "cuda",
                      serve_args: list = SERVE_ARGS,
                      decode_args: list = DECODE_MESH_ARGS) -> list:
    """The two-rank serve and decode phase (:func:`_sharded_rank`) on
    ``cuda:0`` over gloo; ``device`` "cpu" with small arguments rehearses
    it without the card."""
    results = run_ranks(_sharded_rank, world, device, serve_args,
                        decode_args)
    if results[1]["decode_printed"]:
        fail("rank 1 printed a decode record: only rank 0 prints")
    return results


# The two-rank training phase: TRAIN_ARGS with fewer steps (2, then 1 + 1
# timed), and tree_attention alone at the training attention shape.
TRAIN_MESH_ARGS = TRAIN_ARGS + ["--steps", "2", "--iters", "1"]
TREE_SHAPE = (2, 16, 4096, 128)  # B, H, T, D
LAYOUTS = ("contiguous", "zigzag")


def tree_runs(layout: str, world: int, rank: int) -> int:
    """Attention launches (B3 forward, or B6 and B7 each) of one
    single-chunk causal ``tree_attention`` call on ``rank``: the (query
    block, key block) pairs whose key block is not past the query block.
    Contiguous: W blocks, rank ``r`` holds key block ``r``; zigzag: 2W
    half-blocks, rank ``r`` holds ``r`` and ``2W-1-r``."""
    if layout == "contiguous":
        return world - rank
    return (2 * world - rank) + (rank + 1)


def _train_rank(rank: int, world: int, port: int, device: str,
                train_args: list, tree_shape: tuple) -> dict:
    """One rank of the two-rank training phase. (a) ``tree_attention``
    alone in both layouts: this rank's out/lse against the rows of the
    unsharded B3, its dq/dk/dv under a random ``dout`` and non-zero
    ``dlse`` against the rows of the unsharded B6/B7, and the gates on two
    planted faults (the reduce-scatter handing each rank the previous
    rank's slice; the lse cotangent dropped before B6/B7). (b)
    ``cli.main --mode train`` on the mesh in both layouts, every kernel's
    launches and the collectives counted over the run. ``device`` "cpu"
    with a small shape rehearses it without the card (plain versions,
    nothing counted)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.ops import (
        cuda_attention,
        cuda_bwd,
        cuda_decode,
        vjp,
    )
    from tree_attention_tpu_torch.parallel import (
        COLLECTIVES,
        initialize_distributed,
        make_mesh,
    )
    from tree_attention_tpu_torch.parallel import tree as ttree

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, created = initialize_distributed("gloo", device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    mesh = make_mesh({"seq": world})
    out = {"tree": {}, "train": {}}
    try:
        B, H, T, D = tree_shape
        dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        g = torch.Generator(device=dev).manual_seed(11)
        q, k, v, dout = (torch.randn(B, H, T, D, generator=g, device=dev
                                     ).to(dtype) for _ in range(4))
        dlse = torch.randn(B, H, T, generator=g, device=dev)
        # The whole sequence on one rank: B3, then B6/B7 with the same
        # dout and dlse.
        ref_o, ref_l = cuda_attention.attention_cuda_fwd(q, k, v,
                                                         causal=True)
        ref_g = cuda_bwd.attention_cuda_bwd(q, k, v, ref_o, ref_l, dout,
                                            dlse, causal=True)
        lse_f, delta = cuda_bwd.bwd_residuals(ref_o, ref_l, dout, dlse)
        one_key = cuda_bwd.dq_one_key_bound(q, k, v, dout, delta,
                                            causal=True, dlse=dlse)
        # An f32 reference (plain, on the bf16 values) to tell the two
        # bf16 paths' own errors apart.
        f32 = [t.float() for t in (q, k, v, dout)]
        f32_g = cuda_bwd.bwd_plain(
            *f32[:3], *cuda_attention.fwd_plain(*f32[:3], causal=True),
            f32[3], dlse, causal=True)
        del f32

        def rel_to(a, ref):
            """Each row's largest |a - ref| over the row's largest |ref|,
            the worst row."""
            return ((a.float() - ref).abs().amax(-1) / ref.abs().amax(-1)
                    .clamp_min(1e-30)).max().item()
        for layout in LAYOUTS:
            rows = torch.from_numpy(ttree.local_positions(T, mesh, layout)
                                    ).to(dev)
            # The sharded backward's own rounding: each partial's output
            # cotangent cast to bf16 (cuda_bwd.merge_cotangent_allowance).
            allow = [x.index_select(2, rows)
                     for x in cuda_bwd.merge_cotangent_allowance(
                         q, k, v, dout, lse_f,
                         ttree.partial_key_groups(T, world, layout),
                         causal=True)]

            def mine(x):
                return x.index_select(2, rows)

            def attend():
                leaves = [mine(t).requires_grad_() for t in (q, k, v)]
                o, lse = ttree.tree_attention(*leaves, mesh=mesh,
                                              causal=True, layout=layout)
                torch.autograd.backward([o, lse], [mine(dout), mine(dlse)])
                return (o.detach(), lse.detach()), tuple(t.grad
                                                         for t in leaves)

            want = (mine(ref_o), mine(ref_l))
            want_g = tuple(mine(x) for x in ref_g)
            mine_key = tuple(mine(x) for x in one_key)
            attend()  # warm-up
            sync()
            t0 = time.monotonic()
            res, grads = attend()
            sync()
            ms = (time.monotonic() - t0) * 1e3
            fwd = rows_close(res, want)
            bwd = cuda_bwd.grad_rows_close(grads, want_g, TOL_GRAD_REL,
                                           mine_key, allow)
            row_gate_alone = cuda_bwd.grad_rows_close(
                grads, want_g, TOL_GRAD_REL, mine_key)
            # Planted: each rank's reduce-scatter returns the previous
            # rank's rows ...
            scatter = ttree.scatter_rows
            ttree.scatter_rows = lambda x, *a, **kw: scatter(x.roll(1, 0),
                                                             *a, **kw)
            try:
                with torch.no_grad():
                    wrong = ttree.tree_attention(
                        *(mine(t) for t in (q, k, v)), mesh=mesh,
                        causal=True, layout=layout)
            finally:
                ttree.scatter_rows = scatter
            # ... and the backward runs without the lse cotangent (B6/B7,
            # or the blockwise backward of runs below 128 rows).
            bwd_fns = {n: getattr(vjp, n) for n in ("attention_cuda_bwd",
                                                     "attention_bwd_blockwise")}
            for n, fn in bwd_fns.items():
                setattr(vjp, n, lambda *a, _fn=fn, **kw: _fn(*a[:6], None,
                                                             **kw))
            try:
                _, no_dlse = attend()
            finally:
                for n, fn in bwd_fns.items():
                    setattr(vjp, n, fn)
            out["tree"][layout] = {
                "fwd": fwd, "bwd": bwd, "bwd_row_gate_alone": row_gate_alone,
                "vs_f32": {"sharded": [rel_to(a, mine(f)) for a, f in
                                       zip(grads, f32_g)],
                           "unsharded": [rel_to(a, mine(f)) for a, f in
                                         zip(want_g, f32_g)]},
                "allowance_over_row_tol": [
                    (a / (TOL_GRAD_REL * w.float().abs().amax(-1, keepdim=True)
                          ).clamp_min(1e-30)).median().item()
                    for a, w in zip(allow, want_g)],
                "fwd_bwd_ms": ms,
                "wrong_slice": rows_close(wrong, want),
                "dlse_dropped": cuda_bwd.grad_rows_close(
                    no_dlse, want_g, TOL_GRAD_REL, mine_key, allow)}
        del q, k, v, dout, dlse, ref_o, ref_l, ref_g, delta, one_key, lse_f
        del f32_g
        del want, want_g, mine_key, res, grads, wrong, no_dlse, allow
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        counters = {
            "flash_fwd": (cuda_attention.attention_cuda_fwd, "launches"),
            "flash_dq": (cuda_bwd.attention_cuda_dq, "launches"),
            "flash_dkv": (cuda_bwd.attention_cuda_dkv, "launches"),
            "flash_decode": (cuda_decode.attention_cuda_decode, "launches"),
            "flash_decode_tiled": (cuda_decode.attention_cuda_decode,
                                   "tiled_launches"),
        }
        for layout in LAYOUTS:
            for fn, attr in counters.values():
                setattr(fn, attr, 0)
            c0 = dict(COLLECTIVES)
            buf = io.StringIO()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(buf):
                cli.main(train_args + MESH_ARGS + ["--seq-layout", layout])
            sync()
            lines = buf.getvalue().strip().splitlines()
            out["train"][layout] = {
                "rec": json.loads(lines[-1]) if lines else None,
                "wall_s": time.monotonic() - t0,
                "launches": {n: getattr(fn, a)
                             for n, (fn, a) in counters.items()},
                "colls": {f"{a}/{c}": n - c0.get((a, c), 0)
                          for (a, c), n in COLLECTIVES.items()
                          if n - c0.get((a, c), 0)}}
        if dev.type == "cuda":
            out["step_split"] = _traced_mesh_step(dev, mesh, train_args,
                                                  traced=rank == 0)
    finally:
        if created:
            dist.destroy_process_group()
    return out


def _traced_mesh_step(dev, mesh, train_args: list, traced: bool) -> dict:
    """Where one zigzag training step on the mesh spends its wall: the
    median of three untraced steps, and on the traced rank one more step's
    device time by kernel group (torch.profiler; the other rank's kernels,
    on the same card, are not in it). The rest of the wall is the host:
    gloo's collectives and the launches."""
    import torch

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.data import make_lm_batch
    from tree_attention_tpu_torch.models import (
        default_optimizer,
        init_train_state,
        make_train_step,
    )
    from tree_attention_tpu_torch.utils.config import parse_args

    targs = parse_args(train_args + ["--seq-layout", "zigzag"])
    tcfg = cli.transformer_config(targs)
    opt = default_optimizer()
    state = init_train_state(tcfg, opt, seed=0, device=dev, mesh=mesh)
    step = make_train_step(tcfg, opt, mesh=mesh)
    batch = make_lm_batch(torch.Generator().manual_seed(5), targs.batch,
                          targs.seq_len, tcfg.vocab_size, dev, mesh=mesh)
    state, _ = step(state, batch)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out = {"step_walls_ms": walls, "step_wall_ms": sorted(walls)[1]}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with (torch.profiler.profile(activities=acts) if traced
          else contextlib.nullcontext()) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    if traced:
        groups = {"flash_fwd (B3)": ("flash_fwd",),
                  "flash_dq (B6)": ("flash_dq",),
                  "flash_dkv (B7)": ("flash_dkv",),
                  "matmul": ("nvjet", "gemm", "gemv", "sm90", "cutlass",
                             "cublas")}
        split = {g: 0.0 for g in (*groups, "other")}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            low = e.name.lower()
            key = next((g for g, keys in groups.items()
                        if any(x in low for x in keys)), "other")
            split[key] += e.time_range.elapsed_us() / 1e3
        busy = sum(split.values())
        out.update(by_group_ms=split, busy_ms=busy,
                   idle_share=(1 - busy / out["step_wall_ms"]) if busy
                   else None)
    del state, step, batch
    torch.cuda.empty_cache()
    return out


def run_train_ranks(world: int = 2, device: str = "cuda",
                    train_args: list = TRAIN_MESH_ARGS,
                    tree_shape: tuple = TREE_SHAPE) -> list:
    """The two-rank training phase (:func:`_train_rank`) on ``cuda:0``
    over gloo; ``device`` "cpu" with small arguments rehearses it."""
    results = run_ranks(_train_rank, world, device, train_args, tree_shape,
                        what="training")
    if any(r["train"][layout]["rec"] is not None
           for r in results[1:] for layout in LAYOUTS):
        fail("a rank other than 0 printed a train record")
    return results


SPEC_ARGS = ["--speculate", "--draft-k", "4"]
# A verify tick's tree masks: 8 rows (draft_k 4 plus decoys fit), and the
# 32-row cap of the int32 bitmasks.
TREE_TQS = (8, 32)


def random_trees(B: int, tq: int, chain_slot: int, seed: int):
    """``(B, tq, tq)`` bool ancestor masks of random draft trees packed as
    the engine packs a proposal (``pack_proposal``: topological parents,
    the tip at row 0); slot ``chain_slot`` is a plain chain. Row ``tq - 1``
    sees itself, so at tq 32 every slot has a row that sets bit 31."""
    import numpy as np
    import torch

    from tree_attention_tpu_torch.serving.speculation import (
        DraftProposal,
        pack_proposal,
    )

    rng = np.random.default_rng(seed)
    out = np.zeros((B, tq, tq), bool)
    for b in range(B):
        parents = [i - 1 if b == chain_slot else int(rng.integers(-1, i))
                   for i in range(tq - 1)]
        out[b] = pack_proposal(0, DraftProposal(
            np.zeros(tq - 1, np.int32), np.asarray(parents, np.int32))).anc
    return torch.from_numpy(out)


def oracle_drafter(requests, refs, vocab: int, wrong_every: int = 3):
    """The adversarial drafter of the JAX package's spec tests: each
    request's non-speculative continuation ``refs[uid]`` with a wrong
    second token every ``wrong_every``-th call, behind a decoy branch packed
    BEFORE the true chain — every proposal is a tree, an accepted path is
    never contiguous rows, so every commit compacts, and a random-weight
    model accepts where n-gram lookup may not."""
    import numpy as np

    from tree_attention_tpu_torch.serving.speculation import (
        DraftProposal,
        Drafter,
    )

    full = [(np.asarray(r.prompt, np.int32),
             np.concatenate([np.asarray(r.prompt, np.int32),
                             np.asarray(refs[r.uid], np.int32)]))
            for r in requests]

    class Oracle(Drafter):
        calls = 0

        def propose(self, history, k):
            self.calls += 1
            seq = next(f for p, f in full if len(history) >= len(p)
                       and np.array_equal(history[:len(p)], p))
            cont = seq[len(history):len(history) + k].copy()
            if len(cont) == 0:
                cont = np.full((max(k, 1),), 3, np.int32)
            if self.calls % wrong_every == 0 and len(cont) > 1:
                cont[1] = (cont[1] + 1) % vocab
            tokens, parents, prev = [int((cont[0] + 1) % vocab)], [-1], -1
            for t in cont[:max(len(cont) - 1, 1)]:
                parents.append(prev)
                prev = len(tokens)
                tokens.append(int(t))
            return DraftProposal(np.asarray(tokens, np.int32),
                                 np.asarray(parents, np.int32))

    return Oracle()


def replay_margin(params, cfg, results, requests, quant: bool, layout: str,
                  dev, block: int = 64, quant_kernel: str = "q8q",
                  rows_out: Optional[list] = None) -> float:
    """Teacher-forced re-scoring of a greedy serve's emitted tokens through
    the non-speculative kernel path: each request's prompt prefilled
    exactly (an int8 cache then takes it quantized as staged admission
    does: per block on the paged layout, per channel on the contiguous
    one), then every emitted token but the last in one step (an int8
    cache's through the serve's ``quant_kernel`` route). Returns the
    largest (row's max logit - emitted token's logit) over every emitted
    token; a greedy token the model would not pick shows there.
    ``rows_out``, when given, gets each result's replayed logits rows (row
    ``j`` predicts token ``j``), for sampled tokens too."""
    import numpy as np
    import torch

    from tree_attention_tpu_torch.models import (
        forward_step,
        init_cache,
        init_paged_cache,
        paged_insert_slot,
        quantize_cache,
        quantize_paged_blocks,
    )

    prompts = {r.uid: r.prompt for r in requests}
    worst = 0.0
    for res in results:
        prompt = torch.as_tensor(np.asarray(prompts[res.uid]),
                                 dtype=torch.int64, device=dev)[None]
        toks = torch.as_tensor(res.tokens, dtype=torch.int64, device=dev)
        plen, total = prompt.shape[1], prompt.shape[1] + len(res.tokens)
        nb = -(-total // block)

        def paged(q):
            c = init_paged_cache(cfg, 1, total, nb, block=block, device=dev,
                                 quantize=q)
            c.table.copy_(torch.arange(nb, dtype=torch.int32,
                                       device=dev)[None])
            return c

        if not quant:
            cache = (paged(False) if layout == "paged"
                     else init_cache(cfg, 1, total, device=dev))
            lg, _ = forward_step(params, torch.cat([prompt, toks[None, :-1]],
                                                   1), cache, cfg)
            rows = lg[0, plen - 1:]
        else:
            stage = init_cache(cfg, 1, total, device=dev)
            lg, stage = forward_step(params, prompt, stage, cfg)
            rows = lg[0, -1:]
            if layout == "paged":
                cache = paged(True)
                kq, vq, ks, vs = quantize_paged_blocks(stage.k, stage.v,
                                                       block)
                paged_insert_slot(cache, 0, kq, vq, plen, ks, vs)
            else:
                cache = quantize_cache(stage)
            if len(res.tokens) > 1:
                lg, _ = forward_step(params, toks[None, :-1], cache, cfg,
                                     quant_kernel=quant_kernel)
                rows = torch.cat([rows, lg[0]], 0)
        rows = rows.float()
        margin = rows.amax(-1) - rows.gather(1, toks[:, None])[:, 0]
        worst = max(worst, margin.max().item())
        if rows_out is not None:
            rows_out.append(rows)
    return worst


def tree_step_check(params, cfg, dev, slots: int = 8, cache_len: int = 640,
                    block: int = 64, prefix: int = 256, tq: int = 8) -> dict:
    """One tree verify step (random trees, one slot a chain; positions =
    length + depth) on a prefilled paged cache at ragged lengths, one of
    them a window across a block boundary: the kernel path against the
    plain path on copies of the same cache, exact and int8 (the cache
    quantized per block); and each exact tree row against its root path
    decoded one token at a time by the kernel path. Returns the largest
    |dlogit| of each comparison."""
    import dataclasses

    import torch

    from tree_attention_tpu_torch.models import (
        PagedQuantKVCache,
        forward_step,
        init_paged_cache,
    )
    from tree_attention_tpu_torch.ops.cuda_decode import (
        quantize_symmetric_int8,
    )

    nb = cache_len // block
    cache = init_paged_cache(cfg, slots, cache_len, slots * nb, block=block,
                             device=dev)
    cache.table.copy_(torch.arange(slots * nb, dtype=torch.int32,
                                   device=dev).reshape(slots, nb))
    gen = torch.Generator(device=dev).manual_seed(1)
    pre = torch.randint(0, cfg.vocab_size, (slots, prefix), generator=gen,
                        device=dev)
    n0 = torch.randint(1, prefix + 1, (slots,), generator=gen, device=dev,
                       dtype=torch.int32)
    n0[0] = min(2 * block - 3, prefix)  # the window crosses a block edge
    _, cache = forward_step(params, pre, cache, cfg, n_tokens=n0)
    trees = random_trees(slots, tq, 1, 2).to(dev)
    depth = trees.sum(-1) - 1  # a row's ancestors, itself included
    toks = torch.randint(0, cfg.vocab_size, (slots, tq), generator=gen,
                         device=dev)
    plain_cfg = dataclasses.replace(cfg, attn_impl="plain")

    def clone(c):
        return dataclasses.replace(c, **{
            f.name: getattr(c, f.name).clone()
            for f in dataclasses.fields(c)})

    def tree_step(c, conf):
        lg, _ = forward_step(params, toks, clone(c), conf,
                             positions=c.length.long()[:, None] + depth,
                             tree_mask=trees)
        return lg.float()

    lk = tree_step(cache, cfg)
    out = {"logits_err_plain": (lk - tree_step(cache, plain_cfg)
                                ).abs().max().item()}
    # Each row against its root path, one token per step (slots whose path
    # is shorter ride the later steps inert).
    worst = 0.0
    for i in range(tq):
        paths = []
        for b in range(slots):
            anc = trees[b, i].nonzero()[:, 0].tolist()  # ascending = path
            paths.append(anc)
        c = clone(cache)
        last = torch.empty_like(lk[:, 0])
        for s in range(max(len(p) for p in paths)):
            step = torch.tensor([[int(toks[b, p[s]]) if s < len(p) else 0]
                                 for b, p in enumerate(paths)], device=dev)
            n = torch.tensor([int(s < len(p)) for p in paths], device=dev,
                             dtype=torch.int32)
            lg, c = forward_step(params, step, c, cfg, n_tokens=n)
            for b, p in enumerate(paths):
                if s == len(p) - 1:
                    last[b] = lg[b, 0].float()
        worst = max(worst, (last - lk[:, i]).abs().max().item())
    out["logits_err_paths"] = worst

    def per_block(pool):
        codes, sc = quantize_symmetric_int8(
            pool.reshape(*pool.shape[:3], -1), 3)
        return codes.reshape(pool.shape), sc[..., 0]

    (k8, ks8), (v8, vs8) = per_block(cache.k), per_block(cache.v)
    qcache = PagedQuantKVCache(k=k8, v=v8, table=cache.table,
                               length=cache.length, k_scale=ks8,
                               v_scale=vs8)
    out["int8_logits_err_plain"] = (
        tree_step(qcache, cfg) - tree_step(qcache, plain_cfg)
    ).abs().max().item()
    return out


def spec_phase(dev, params, cfg, serve_args, trace, refs, engine_kw,
               wrappers, reset_counts, tol_logits) -> dict:
    """Phase 3d: speculative serving at the serve width.

    (a) ``cli.run_serve`` (what ``cli.main --mode serve --speculate``
    runs) with the ``ngram`` and ``ngram-tree`` drafters, exact and
    ``--kv-quant int8``, on the serve phase's trace; (b) the oracle drafter
    in process on the wave's trace (``refs``: its non-speculative greedy
    tokens, exact and int8) on the paged and contiguous layouts, exact and
    int8 through both q8 routes (q8q: B5 / B4; q8, the cast route: B2 with
    per-block scales / B1). Every serve retires every request with its
    budget and drains its pool; each tree verify tick launches the layout's
    tree kernel once per layer (and no other tree kernel runs), and the
    kernel's multi-row body (its cast route's, for q8) at least once per
    tree launch; the oracle's acceptance is above 0 on the paged layouts;
    every emitted token passes the teacher-forced replay
    (:func:`replay_margin` within ``tol_logits``); (c) a sampled
    wave served plain and then speculatively (the oracle drafting the plain
    serve's sampled tokens) under one seed. Token agreement with the
    non-speculative serves is reported, not gated. On a CPU the launch
    counts are not read (the wrappers run their plain versions)."""
    import torch

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.serving import SlotServer, synthetic_trace
    from tree_attention_tpu_torch.utils.config import parse_args

    on_card = dev.type == "cuda"
    # The tree kernel of each (layout, q8 route; None: exact).
    tree_kernel = {("paged", None): "flash_decode_paged",
                   ("paged", "q8q"): "flash_decode_paged_q8q",
                   ("paged", "q8"): "flash_decode_paged",
                   ("contiguous", None): "flash_decode",
                   ("contiguous", "q8q"): "flash_decode_q8q",
                   ("contiguous", "q8"): "flash_decode"}
    n_layers = cfg.n_layers

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def check(label, rep, server, n_req, n_new, layout, route):
        """The gates every speculative serve passes; returns its facts.
        ``route``: the q8 route of an int8 cache, None for an exact one."""
        tree = {n: w.tree_launches for n, w in wrappers.items()
                if hasattr(w, "tree_launches")}
        ticks = rep.spec["tree_verify_ticks"]
        if rep.outcomes != {"budget": n_req} or \
                rep.tokens_generated != n_req * n_new:
            fail(f"spec serve {label}: outcomes {rep.outcomes}, "
                 f"{rep.tokens_generated} tokens")
        if any(server.leak_report().values()):
            fail(f"spec serve {label} leaked: {server.leak_report()}")
        mine = tree_kernel[(layout, route)]
        if on_card and (tree[mine] != n_layers * ticks or any(
                c for n, c in tree.items() if n != mine)):
            fail(f"spec serve {label}: tree launches {tree} over {ticks} "
                 f"tree verify ticks x {n_layers} layers")
        # Every verify tick (tree or chain, Tq >= 8) runs the layout's
        # kernel on the multi-row body (B2, B1, B5, B4; the cast route's
        # for q8, counted apart from the exact staged prompt tails).
        tiled = getattr(wrappers[mine], "cast_tiled_launches"
                        if route == "q8" else "tiled_launches")
        if on_card and not (tiled >= tree[mine] and tiled > 0):
            fail(f"spec serve {label}: {mine}'s multi-row body launched "
                 f"{tiled} times beside {tree[mine]} tree launches")
        by_tq = {n: dict(sorted(wrappers[k].tiled_tq.items()))
                 for n, k in (("B1", "flash_decode"),
                              ("B2", "flash_decode_paged"),
                              ("B4", "flash_decode_q8q"),
                              ("B5", "flash_decode_paged_q8q"))
                 if wrappers[k].tiled_tq}
        return {"spec": rep.spec, "tokens_per_sec": rep.tokens_per_sec,
                "wall_s": rep.wall_s, "ticks": rep.ticks,
                "decode_ticks": rep.decode_ticks, "route": route,
                "layout": layout, "tree_launches": tree[mine],
                "tree_kernel": mine, "tiled_launches": tiled,
                "tiled_by_tq": by_tq}

    out = {"cli": {}, "oracle": {}}
    for quant in ("none", "int8"):
        for drafter in ("ngram", "ngram-tree"):
            label = f"cli {drafter} kv_quant {quant}"
            c = parse_args(serve_args + SPEC_ARGS + ["--drafter", drafter,
                                                     "--kv-quant", quant])
            reset_counts()
            rec, server, rep = cli.run_serve(c, dev)
            sync()
            r = check(label, rep, server, c.requests, c.max_new_tokens,
                      "paged", None if quant == "none" else "q8q")
            reqs = synthetic_trace(
                c.requests, prompt_len=c.prompt_len,
                prompt_jitter=c.prompt_jitter,
                max_new_tokens=c.max_new_tokens,
                arrival_every=c.arrival_every,
                vocab_size=server.cfg.vocab_size, seed=c.seed + 1)
            r["replay_margin"] = replay_margin(
                server.params, server.cfg, rep.results, reqs,
                quant != "none", "paged", dev, server.kv_block)
            r["tokens"] = {x.uid: x.tokens for x in rep.results}
            r["record"] = rec
            out["cli"][label] = r
            print(f"spec serve ({label}): {rec['tokens_per_sec']} tok/s, "
                  f"spec {json.dumps(rep.spec)}, tree launches "
                  f"{r['tree_launches']}, multi-row launches by Tq "
                  f"{json.dumps(r['tiled_by_tq'])}, replay margin "
                  f"{r['replay_margin']:.3e} (tol {tol_logits})", flush=True)
            if not r["replay_margin"] <= tol_logits:
                fail(f"spec serve ({label}): an emitted token is "
                     f"{r['replay_margin']} below its position's largest "
                     f"logit on the non-speculative path")
            del server
    n_new = max(r.max_new_tokens for r in trace)
    for layout in ("paged", "contiguous"):
        for route in (None, "q8q", "q8"):
            quant = route is not None
            label = (f"oracle {layout}{' int8' if quant else ''}"
                     f"{' q8' if route == 'q8' else ''}")
            ref = refs[quant]
            server = SlotServer(
                params, cfg, **engine_kw, kv_layout=layout, quantize=quant,
                quant_kernel=route or "q8q", speculate=True, draft_k=4,
                drafter=oracle_drafter(trace, ref, cfg.vocab_size))
            reset_counts()
            rep = server.serve(trace)
            sync()
            r = check(label, rep, server, len(trace), n_new, layout, route)
            if on_card and not r["tree_launches"]:
                fail(f"spec serve ({label}): no tree verify tick")
            same = sum(a == b for x in rep.results
                       for a, b in zip(x.tokens, ref[x.uid]))
            r["tokens_equal_to_nonspec"] = same / rep.tokens_generated
            r["replay_margin"] = replay_margin(
                params, cfg, rep.results, trace, quant, layout, dev,
                engine_kw.get("kv_block", 64), route or "q8q")
            out["oracle"][label] = r
            print(f"spec serve ({label}): {rep.tokens_per_sec:.1f} tok/s, "
                  f"spec {json.dumps(rep.spec)}, tree launches "
                  f"{r['tree_launches']} ({r['tree_kernel']}), multi-row "
                  f"launches by Tq {json.dumps(r['tiled_by_tq'])}, tokens "
                  f"equal "
                  f"to the non-spec wave's {same}/{rep.tokens_generated}, "
                  f"replay margin {r['replay_margin']:.3e} (tol "
                  f"{tol_logits})", flush=True)
            if layout == "paged" and not rep.spec["acceptance_rate"] > 0:
                fail(f"spec serve ({label}): acceptance rate "
                     f"{rep.spec['acceptance_rate']}")
            if not r["replay_margin"] <= tol_logits:
                fail(f"spec serve ({label}): an emitted token is "
                     f"{r['replay_margin']} below its position's largest "
                     f"logit on the non-speculative path")
            del server
    # (c) Sampled: the wave at temperature 0.8, top-k 50 under one seed,
    # served plain, then speculatively with the oracle drafting the plain
    # serve's own sampled tokens (keyed draws: on exact arithmetic the two
    # streams are one). Both retire and drain; agreement is reported.
    samp = dict(temperature=0.8, top_k=50, seed=11)
    server = SlotServer(params, cfg, **engine_kw, **samp)
    plain = server.serve(trace)
    sync()
    if plain.outcomes != {"budget": len(trace)} or any(
            server.leak_report().values()):
        fail(f"sampled plain serve: outcomes {plain.outcomes}, leaks "
             f"{server.leak_report()}")
    sref = {x.uid: x.tokens for x in plain.results}
    label = "oracle paged sampled"
    server = SlotServer(params, cfg, **engine_kw, **samp, speculate=True,
                        draft_k=4,
                        drafter=oracle_drafter(trace, sref, cfg.vocab_size))
    reset_counts()
    rep = server.serve(trace)
    sync()
    r = check(label, rep, server, len(trace), n_new, "paged", None)
    same = sum(a == b for x in rep.results
               for a, b in zip(x.tokens, sref[x.uid]))
    r["tokens_equal_to_nonspec"] = same / rep.tokens_generated
    r["nonspec_tokens_per_sec"] = plain.tokens_per_sec
    out["oracle"][label] = r
    print(f"spec serve ({label}): {rep.tokens_per_sec:.1f} tok/s beside "
          f"the sampled plain serve's {plain.tokens_per_sec:.1f}, spec "
          f"{json.dumps(rep.spec)}, tree launches {r['tree_launches']}, "
          f"tokens equal to the sampled plain serve's "
          f"{same}/{rep.tokens_generated} (reported, not gated)", flush=True)
    del server
    return out


# The prefix phase: the serve phase's trace with three quarters of its
# prompts opening on one shared 384-token prefix (six 64-token blocks).
PREFIX_ARGS = ["--prefix-cache", "--prefix-share", "0.75",
               "--prefix-len", "384"]
# Its four serves: (flags beside the serve phase's, layout, q8 route).
PREFIX_SERVES = {
    "exact paged": ([], "paged", None),
    "int8 paged (B5)": (["--kv-quant", "int8"], "paged", "q8q"),
    "int8-cast paged": (["--kv-quant", "int8-cast"], "paged", "q8"),
    # 8 requests on 4 slots: the second four admit after the first four
    # published.
    "exact contiguous (B1)": (["--kv-layout", "contiguous", "--requests",
                               "8", "--slots", "4"], "contiguous", None),
}


@contextlib.contextmanager
def prefix_watch():
    """Watch a serve's prefix work from outside the engine: the prompt
    tokens its chunks computed, and the bytes (K, V; int8 codes with their
    scales) of every block the paged index adopted, read from the pool at
    adoption. ``fault`` plants one of two faults for the gate to reject:
    ``"table"`` — each paged hit's table row names the wrong shared blocks
    (every matched entry past the first names the first matched block; a
    permutation of the entries would not do: each key carries its rotary
    position, and attention over a set of keys ignores where they sit);
    ``"dequant"`` — an int8 paged hit's dequantized prefix dropped (zero
    rows, staging length 0)."""
    import torch

    from tree_attention_tpu_torch.models import gather_kv_blocks
    from tree_attention_tpu_torch.serving import engine

    seen = {"prefill_tokens": 0, "blocks": {}, "fault": None}
    cls = engine.SlotServer
    consume, publish, hit = (cls._consume_chunk, cls._publish_prefix,
                             cls._paged_hit)
    dequant = engine.insert_dequant_prefix

    def counted(self, slot, n, last):
        seen["prefill_tokens"] += n
        return consume(self, slot, n, last)

    def snapped(self, slot):
        held = {id(x) for x in self._slot_nodes[slot]}
        publish(self, slot)
        new = [x.block_id for x in self._slot_nodes[slot]
               if id(x) not in held]
        if self._paged_prefix and new:
            c = self.cache
            parts = gather_kv_blocks(
                c.k, c.v, torch.tensor(new),
                *((c.k_scale, c.v_scale) if self.quantize else ()))
            for i, b in enumerate(new):
                seen["blocks"][b] = [p[i].clone() for p in parts]

    def wrong_row(self, slot, resv):
        matched = hit(self, slot, resv)
        if seen["fault"] == "table" and len(resv[1]) > 1:
            self._host_table[slot, 1:len(resv[1])] = \
                self._host_table[slot, 0]
        return matched

    def dropped(staging, *args):
        if seen["fault"] != "dequant":
            return dequant(staging, *args)
        staging.k.zero_()
        staging.v.zero_()
        staging.length.zero_()
        return staging

    cls._consume_chunk, cls._publish_prefix, cls._paged_hit = (
        counted, snapped, wrong_row)
    engine.insert_dequant_prefix = dropped
    try:
        yield seen
    finally:
        cls._consume_chunk, cls._publish_prefix, cls._paged_hit = (
            consume, publish, hit)
        engine.insert_dequant_prefix = dequant


def prefix_phase(dev, card, serve_args, wrappers, reset_counts, tol_logits,
                 split_by=None, groups=None, prefix_args=PREFIX_ARGS,
                 serves=PREFIX_SERVES, faults=("table", "dequant")) -> dict:
    """Phase 3f: the radix prefix cache at the serve width, through
    ``cli.run_serve`` (what ``cli.main --mode serve --prefix-cache``
    runs) on the serve phase's trace with ``prefix_args``: the four
    ``PREFIX_SERVES``, each beside the same trace served with the same
    flags and the cache off. Gates: every request retires with its budget;
    hits > 0 and ``tokens_reused`` equal to the requests' summed
    ``prefix_hit_tokens``, each a multiple of the block and at most the
    shared prefix's whole blocks; the pool drains to tree-owned blocks;
    the prompt tokens computed equal the prompts less their matched
    tokens; every block the paged index adopted still holds the bytes it
    held at adoption (the exact hit moves none: ``hit_bytes_moved`` 0);
    the one-row paged ticks run on the tick body; every emitted greedy
    token lies within ``tol_logits`` of its position's largest logit on
    the cache-off path (:func:`replay_margin`), and the gate rejects the
    two planted faults of :func:`prefix_watch`. With ``split_by``, one
    traced exact paged serve's device time by kernel ``groups``. ``card``
    (the card's name and power limit) heads each serve's line. On a CPU
    the launch counts are not read."""
    import torch

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.models import gather_kv_blocks
    from tree_attention_tpu_torch.serving import SlotServer, synthetic_trace
    from tree_attention_tpu_torch.utils.config import parse_args

    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def counts():
        c = launch_counts(wrappers)
        c["tiled_by_tq"] = {n: dict(sorted(w.tiled_tq.items()))
                            for n, w in wrappers.items()
                            if getattr(w, "tiled_tq", None)}
        return c

    def serve(argv, fault=None):
        """One serve with the counts set to 0 just before it and read just
        after; its record, server, report, trace, launches and watch."""
        c = parse_args(argv)
        with prefix_watch() as seen:
            seen["fault"] = fault
            reset_counts()
            rec, server, rep = cli.run_serve(c, dev)
            sync()
            launches = counts()
        reqs = synthetic_trace(
            c.requests, prompt_len=c.prompt_len,
            prompt_jitter=c.prompt_jitter, max_new_tokens=c.max_new_tokens,
            arrival_every=c.arrival_every, vocab_size=server.cfg.vocab_size,
            seed=c.seed + 1, prefix_share=c.prefix_share,
            prefix_len=c.prefix_len)
        return rec, server, rep, reqs, launches, seen

    def margin(server, rep, reqs, layout, route):
        return replay_margin(server.params, server.cfg, rep.results, reqs,
                             route is not None, layout, dev,
                             server.kv_block if layout == "paged" else 64,
                             route or "q8q")

    out = {"serves": {}, "faults": {}}
    for label, (flags, layout, route) in serves.items():
        argv = serve_args + prefix_args + flags
        c = parse_args(argv)
        block = c.prefix_block
        most = c.prefix_len // block * block
        n_req, n_new = c.requests, c.max_new_tokens
        off_rec, _, off_rep, _, off_launches, off_seen = serve(
            [a for a in argv if a != "--prefix-cache"])
        rec, server, rep, reqs, launches, seen = serve(argv)
        pre = rep.prefix
        hit_tokens = [r.prefix_hit_tokens for r in rep.results]
        prompts = {r.uid: len(r.prompt) for r in reqs}
        leaks = server.leak_report()
        # The blocks the tree holds now, and their bytes at adoption.
        tree = []
        stack = list(server._prefix._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            tree.append(node.block_id)
        changed = None
        if layout == "paged":
            cache = server.cache
            parts = gather_kv_blocks(
                cache.k, cache.v, torch.tensor(tree),
                *((cache.k_scale, cache.v_scale) if route else ()))
            changed = sum(
                not all(torch.equal(p[i], s) for p, s in
                        zip(parts, seen["blocks"][b]))
                for i, b in enumerate(tree))
        same = sum(a == b for x, y in zip(rep.results, off_rep.results)
                   for a, b in zip(x.tokens, y.tokens))
        r = {
            "record": rec, "cache_off": {k: off_rec[k] for k in (
                "tokens_per_sec", "ttft_p50_s", "ttft_p95_s", "tbt_p50_s",
                "tbt_p95_s", "wall_s")},
            "prefix": pre, "prefix_hit_tokens": hit_tokens,
            "prefill_tokens": seen["prefill_tokens"],
            "prefill_tokens_cache_off": off_seen["prefill_tokens"],
            "leaks": leaks, "tree_blocks": len(tree),
            "tree_blocks_changed_since_adoption": changed,
            "tokens_equal_to_cache_off": same,
            "launches": launches, "launches_cache_off": off_launches,
            "replay_margin": margin(server, rep, reqs, layout, route),
        }
        out["serves"][label] = r
        if label == "exact paged":
            # For the traced serve below: a fresh engine of this one's
            # configuration, weights and trace.
            traced_kw = dict(
                slots=c.slots, cache_len=server.cache_len,
                prefill_chunk=c.prefill_chunk,
                prefill_budget=c.prefill_budget, kv_block=server.kv_block,
                kv_blocks=server.kv_blocks, prefix_cache=True,
                prefix_block=c.prefix_block, temperature=c.temperature)
            traced_run = (server.params, server.cfg, reqs, rep.wall_s)
        print(f"prefix serve ({label}; {card}): cache on / off "
              f"{rec['tokens_per_sec']} / {off_rec['tokens_per_sec']} tok/s, "
              f"ttft p50 {rec['ttft_p50_s']} / {off_rec['ttft_p50_s']} s, "
              f"p95 {rec['ttft_p95_s']} / {off_rec['ttft_p95_s']} s, "
              f"prefill tokens computed {r['prefill_tokens']} / "
              f"{r['prefill_tokens_cache_off']}; prefix {json.dumps(pre)}; "
              f"hit tokens {hit_tokens}; tree blocks {len(tree)} (changed "
              f"since adoption: {changed}); leaks {json.dumps(leaks)}; "
              f"tokens equal to the cache-off serve's {same}/"
              f"{rep.tokens_generated}, replay margin "
              f"{r['replay_margin']:.3e} (tol {tol_logits}); launches "
              f"{json.dumps(launches)}", flush=True)
        if rep.outcomes != {"budget": n_req} or \
                rep.tokens_generated != n_req * n_new:
            fail(f"prefix serve ({label}): outcomes {rep.outcomes}, "
                 f"{rep.tokens_generated} tokens")
        if not (pre["hits"] > 0 and pre["tokens_reused"] == sum(hit_tokens)
                and all(h % block == 0 and h <= most for h in hit_tokens)):
            fail(f"prefix serve ({label}): prefix {pre}, hit tokens "
                 f"{hit_tokens}")
        if leaks["blocks_private"] or leaks["blocks_reserved"] or \
                leaks["pins"] or leaks["blocks_used"] != (
                    leaks["blocks_cached"] if layout == "paged" else 0):
            fail(f"prefix serve ({label}) leaked: {leaks}")
        if r["prefill_tokens"] != sum(prompts[x.uid] - x.prefix_hit_tokens
                                      for x in rep.results) or \
                r["prefill_tokens_cache_off"] != sum(prompts.values()):
            fail(f"prefix serve ({label}): {r['prefill_tokens']} / "
                 f"{r['prefill_tokens_cache_off']} prefill tokens computed")
        if layout == "paged" and (changed or not tree):
            fail(f"prefix serve ({label}): {changed} of {len(tree)} tree "
                 f"blocks changed since their adoption")
        if label == "exact paged" and pre["hit_bytes_moved"]:
            fail(f"prefix serve ({label}): the hits moved "
                 f"{pre['hit_bytes_moved']} device bytes")
        if not r["replay_margin"] <= tol_logits:
            fail(f"prefix serve ({label}): an emitted token is "
                 f"{r['replay_margin']} below its position's largest logit "
                 f"on the cache-off path")
        if on_card:
            # The kernels of the path ran: the one-row decode ticks (all on
            # the tick body where paged) and B3 for the chunks of 128 rows
            # and more.
            tick = {(None, "paged"): "flash_decode_paged",
                    ("q8", "paged"): "flash_decode_paged",
                    ("q8q", "paged"): "flash_decode_paged_q8q",
                    (None, "contiguous"): "flash_decode"}[(route, layout)]
            ticks = launches.get(tick + "_tick", 0)
            multi = launches.get(tick + ("_cast_tiled" if route == "q8"
                                         else "_tiled"), 0)
            if not launches["flash_fwd"] or not launches[tick] or (
                    layout == "paged" and route is None
                    and ticks + multi != launches[tick]) or (
                    layout == "paged" and route is not None
                    and ticks != launches[tick]):
                fail(f"prefix serve ({label}): launches {launches}")
        del server
    # The gate's teeth: each planted fault must push a token past it.
    for fault in faults:
        flags = (["--kv-quant", "int8", "--requests", "8"]
                 if fault == "dequant" else
                 ["--requests", "8", "--slots", "4"])
        route = "q8q" if fault == "dequant" else None
        _, server, rep, reqs, _, _ = serve(
            serve_args + prefix_args + flags, fault=fault)
        m = margin(server, rep, reqs, "paged", route)
        out["faults"][fault] = {"replay_margin": m, "prefix": rep.prefix}
        print(f"prefix serve, planted fault {fault!r}: hits "
              f"{rep.prefix['hits']}, replay margin {m:.3e} (the gate, "
              f"{tol_logits}, must reject it)", flush=True)
        if not rep.prefix["hits"] or m <= tol_logits:
            fail(f"prefix serve: the gate passed the planted fault {fault!r}"
                 f" (margin {m}, hits {rep.prefix['hits']})")
        del server
    if split_by is not None:
        # The exact paged prefix serve once more, traced (serve() alone,
        # the weights' set-up outside the trace): its device time by
        # kernel group beside the untraced serve's wall above.
        params, cfg, reqs, wall_s = traced_run
        engine = SlotServer(params, cfg, **traced_kw)
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            prof_rep = engine.serve(reqs)
            sync()
        split, by_kernel = split_by(prof, groups)
        busy = sum(split.values())
        wall_ms = wall_s * 1e3
        out["breakdown"] = {
            "serve_wall_ms": wall_ms,
            "traced_serve_wall_ms": prof_rep.wall_s * 1e3,
            "device_busy_ms": busy,
            "idle_share": (1 - busy / wall_ms) if busy else None,
            "by_group_ms": split,
            "top_kernels_ms": dict(sorted(by_kernel.items(),
                                          key=lambda kv: -kv[1])[:12]),
            "prefix": prof_rep.prefix,
        }
        print(f"prefix serve breakdown (exact paged, 16 requests): "
              + (json.dumps({k: round(v, 3) for k, v in split.items()})
                 + f" busy {busy:.2f} ms (traced) of {wall_ms:.2f} ms "
                 f"untraced wall, idle share "
                 f"{out['breakdown']['idle_share']:.4f}"
                 if busy else "device time not measured"), flush=True)
        del engine, params
    return out


INGRESS_ARGS = ["--max-queue", "4"]


def _http_client(port, body, *, stream=True, retry=True, close_after=None,
                 path="/v1/completions", timeout=300):
    """One HTTP client of the ingress phase, on ``http.client``: POST
    ``body`` (again after each 429, once its ``Retry-After`` passed, when
    ``retry``), then read the SSE stream (closing the socket after
    ``close_after`` tokens) or the whole body. Returns the statuses seen,
    the ``Retry-After`` values, and for the accepted POST its uid, tokens,
    finish reason, the seconds from the POST to the first token event and
    between token events."""
    import http.client

    out = {"statuses": [], "retry_after": [], "uid": None, "tokens": [],
           "finish": None, "ttft_s": None, "gaps_s": []}
    if not stream:
        body = {**body, "stream": False}
    while True:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        t_post = time.monotonic()
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        out["statuses"].append(resp.status)
        if resp.status == 429 and retry:
            wait = int(resp.getheader("Retry-After"))
            out["retry_after"].append(wait)
            resp.read()
            conn.close()
            time.sleep(wait)
            continue
        break
    if resp.status == 429:
        out["retry_after"].append(int(resp.getheader("Retry-After")))
    if resp.status != 200:
        out["body"] = resp.read().decode()
        conn.close()
        return out
    if not stream:
        whole = json.loads(resp.read())
        conn.close()
        out["uid"] = int(whole["id"].split("-")[1])
        out["tokens"] = whole["choices"][0]["token_ids"]
        out["finish"] = whole["choices"][0]["finish_reason"]
        return out
    last = None
    while True:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        if line[6:] == b"[DONE]":
            break
        ev = json.loads(line[6:])
        now = time.monotonic()
        out["uid"] = int(ev["id"].split("-")[1])
        ch = ev["choices"][0]
        if ch["token_ids"]:
            if last is None:
                out["ttft_s"] = now - t_post
            else:
                out["gaps_s"].append(now - last)
            last = now
            out["tokens"].extend(ch["token_ids"])
        if ch["finish_reason"] is not None:
            out["finish"] = ch["finish_reason"]
        if close_after is not None and len(out["tokens"]) >= close_after:
            break  # vanish mid-stream: the server's next write fails
    resp.close()
    conn.close()
    return out


def _in_threads(calls):
    """Run each ``(fn, kwargs)`` on a thread of its own, all started
    together; their results in order."""
    import threading

    res = [None] * len(calls)

    def run(i, fn, kw):
        res[i] = fn(**kw)

    threads = [threading.Thread(target=run, args=(i, fn, kw))
               for i, (fn, kw) in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return res


def leaks_clean(lr) -> bool:
    """The drained engine holds no request's blocks, reservation or pin:
    the pool holds only the prefix tree's blocks (none without it)."""
    return (lr["blocks_private"] == 0 and lr["blocks_reserved"] == 0
            and lr["pins"] == 0 and lr["blocks_used"] == lr["blocks_cached"])


@contextlib.contextmanager
def ingress_faults(fault):
    """Plant one of two faults for the ingress gates to reject:
    ``"leak"`` — a cancel's retire forgets the slot's private blocks
    instead of freeing them; ``"swap"`` — the third token delivered to a
    stream is replaced by the next token id."""
    from tree_attention_tpu_torch.serving import engine

    cls = engine.SlotServer
    retire, deliver = cls._retire, cls._deliver_token
    seen = {"delivered": 0}

    def leaky(self, slot, tick, outcome, results):
        if outcome == engine.OUTCOME_CANCELLED:
            self._slot_private[slot] = set()
        return retire(self, slot, tick, outcome, results)

    def swapped(self, req, index, tok):
        seen["delivered"] += 1
        if seen["delivered"] == 3:
            tok = (tok + 1) % self.cfg.vocab_size
        return deliver(self, req, index, tok)

    if fault == "leak":
        cls._retire = leaky
    else:
        cls._deliver_token = swapped
    try:
        yield
    finally:
        cls._retire, cls._deliver_token = retire, deliver


# The flight recorder's ring in phases 3g and 3k: room for every tick of
# their serves (each ~100-700 ticks), so the records are the whole run.
FLIGHT_CAPACITY = 1 << 14


@contextlib.contextmanager
def host_fetch_watch():
    """Count the host's reads of the card inside the block: ``.cpu()``,
    ``.item()``, ``.tolist()``, ``.numpy()`` and ``.to(<cpu>)`` of a CUDA
    tensor (``fetches``), and ``torch.cuda.synchronize`` and the events' and
    streams' ``synchronize`` (``syncs``). A serve's one fetch a tick is its
    ``.cpu()`` of the tick's tokens."""
    import torch

    seen = {"fetches": 0, "syncs": 0}

    def to_cpu(a, kw):
        t = a[0]
        dst = kw.get("device", a[1] if len(a) > 1 else None)
        if isinstance(dst, torch.Tensor):
            dst = dst.device
        return (t.is_cuda and isinstance(dst, (str, torch.device))
                and torch.device(dst).type == "cpu")

    def cuda_self(a, kw):
        return a[0].is_cuda

    patches = [(torch.Tensor, n, "fetches", cuda_self)
               for n in ("cpu", "item", "tolist", "numpy")]
    patches += [(torch.Tensor, "to", "fetches", to_cpu),
                (torch.cuda, "synchronize", "syncs", None),
                (torch.cuda.Event, "synchronize", "syncs", None),
                (torch.cuda.Stream, "synchronize", "syncs", None)]
    saved = []
    for owner, name, key, pred in patches:
        orig = getattr(owner, name)
        saved.append((owner, name, owner.__dict__.get(name)))

        def counted(*a, _orig=orig, _key=key, _pred=pred, **kw):
            if _pred is None or _pred(a, kw):
                seen[_key] += 1
            return _orig(*a, **kw)

        setattr(owner, name, counted)
    try:
        yield seen
    finally:
        for owner, name, own in reversed(saved):
            if own is None:
                delattr(owner, name)
            else:
                setattr(owner, name, own)


def _http_get(port, path, timeout=60):
    """``(status, body)`` of one GET on 127.0.0.1 (an error status too)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def parse_prometheus(text: str) -> dict:
    """Text exposition format 0.0.4 into ``{(series, labels): value}``;
    raises on a line it cannot read."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, value = line.rsplit(" ", 1)
        labels = ()
        if head.endswith("}"):
            head, _, rest = head[:-1].partition("{")
            pairs = []
            for pair in rest.split('",'):
                k, _, v = pair.partition('="')
                pairs.append((k, v.rstrip('"')))
            labels = tuple(sorted(pairs))
        out[(head, labels)] = float(value)
    return out


def json_samples(snapshot: dict) -> dict:
    """A ``/metrics.json`` snapshot's counters and gauges, and its
    histograms' ``_count`` and ``_sum``, keyed as :func:`parse_prometheus`
    keys them."""
    out = {}
    for m in snapshot["metrics"]:
        for s in m["samples"]:
            labels = tuple(sorted((k, str(v)) for k, v in s["labels"].items()))
            if m["type"] == "histogram":
                out[(m["name"] + "_count", labels)] = float(s["count"])
                out[(m["name"] + "_sum", labels)] = float(s["sum"])
            else:
                out[(m["name"], labels)] = float(s["value"])
    return out


# flight_ab's serves: the engine's first serve (it pays the engine's
# warm-up, so it is gated but not timed), then the two settings in turns.
FLIGHT_AB_TURNS = ("unarmed", "armed", "unarmed", "unarmed", "armed")


def flight_ab(server, trace, wrappers, reset_counts, on_card) -> dict:
    """One static trace (``trace()`` makes it) served on ``server``
    unarmed and armed (the registry on, the flight recorder and the
    request ledger armed, a ``MetricsHTTPServer`` attached to the
    engine), in the turns of
    :data:`FLIGHT_AB_TURNS`. Each serve's launches (set to 0 just before
    it, read just after), host reads of the card
    (:func:`host_fetch_watch`), executed ticks and tok/s; an armed serve's
    records and its ticks that paid a fetch (``host_sync``). The trace is
    static and greedy, so every serve runs the same ticks: their tokens,
    launches and host reads must be equal. An armed serve's
    ``ServeReport.requests`` must be ``aggregate_ledgers`` of its results'
    ledgers (one a request, reconciled: :func:`ledger_gates`), an unarmed
    one's empty. The tok/s ratio is the armed serves' mean over the warm
    unarmed serves' mean."""
    import torch

    from tree_attention_tpu_torch import obs
    from tree_attention_tpu_torch.obs.http import MetricsHTTPServer

    serves = []
    for label in FLIGHT_AB_TURNS:
        mhttp = None
        spent = [0.0]  # host seconds building and appending the records
        if label == "armed":
            obs.FLIGHT.clear()
            obs.FLIGHT.arm(capacity=FLIGHT_CAPACITY)
            obs.REGISTRY.enable()
            obs.REQLOG.arm()
            mhttp = MetricsHTTPServer(0)
            mhttp.start()
            mhttp.attach_engine(server)
            build, append = server._tick_rec, obs.FLIGHT.record

            def timed(fn):
                def call(*a, **kw):
                    t = time.perf_counter()
                    try:
                        return fn(*a, **kw)
                    finally:
                        spent[0] += time.perf_counter() - t
                return call

            server._tick_rec = timed(build)
            obs.FLIGHT.record = timed(append)
        try:
            reset_counts()
            with host_fetch_watch() as seen:
                rep = server.serve(trace())
            if on_card:
                torch.cuda.synchronize()
            launches = launch_counts(wrappers)
        finally:
            if mhttp is not None:
                del server._tick_rec, obs.FLIGHT.record
                mhttp.stop()
                obs.REGISTRY.disable()
                obs.FLIGHT.disarm()
                obs.REQLOG.disarm()
        ledgers = [r.ledger for r in rep.results]
        rec = {"label": label, "launches": launches, **seen,
               "ticks": rep.ticks, "tokens": rep.tokens_generated,
               "tokens_per_sec": rep.tokens_per_sec,
               "streams": {r.uid: list(map(int, r.tokens))
                           for r in rep.results},
               "requests": rep.requests}
        if label == "armed":
            rec["ledger"] = {
                "one_per_request": all(lg is not None for lg in ledgers),
                **(ledger_gates(ledgers, [len(r.tokens)
                                          for r in rep.results])
                   if all(ledgers) else {}),
                "report_equal_aggregate": bool(rep.requests)
                and rep.requests == obs.aggregate_ledgers(ledgers)}
        else:
            rec["ledger"] = {"report_empty": rep.requests == {}
                             and not any(ledgers)}
        if label == "armed":
            recs = obs.FLIGHT.snapshot()["records"]
            rec["host_sync_ticks"] = sum(1 for r in recs
                                         if r.get("host_sync"))
            rec["records"] = len(recs)
            rec["record_us_per_tick"] = spent[0] * 1e6 / max(rep.ticks, 1)
            rec["wall_s"] = rep.wall_s
        serves.append(rec)
    first = serves[0]
    armed = [r for r in serves if r["label"] == "armed"]
    warm = [r for r in serves[1:] if r["label"] == "unarmed"]

    def same(key):
        return all(r[key] == first[key] for r in serves)

    out = {"unarmed": first, "armed": armed[0], "gates": {
        "tokens_equal": same("streams"),
        "launches_equal": same("launches"),
        "fetches_equal": same("fetches") and same("syncs"),
        "records_are_ticks": all(r["records"] == r["ticks"] == first["ticks"]
                                 for r in armed),
        "ledger": all(v for r in serves for v in r["ledger"].values()),
    }}
    if on_card:  # a CPU tensor's reads are not the card's
        out["gates"]["one_fetch_per_sync_tick"] = all(
            r["fetches"] == r["host_sync_ticks"] for r in armed)
    for r in serves:
        r.pop("streams")
    out["tokens_per_sec"] = [[r["label"], r["tokens_per_sec"]]
                             for r in serves]
    mean_a = sum(r["tokens_per_sec"] for r in armed) / len(armed)
    mean_u = sum(r["tokens_per_sec"] for r in warm) / len(warm)
    out["tok_s_armed_over_unarmed"] = mean_a / mean_u if mean_u else None
    return out


def flight_run_gates(rep, flight_snap, server) -> dict:
    """The flight records of one drained serve against its report:
    executed ticks recorded once each in order (sweep-only records
    apart), Σ tokens emitted = the report's tokens, the last tick's pool
    blocks = the pool's, and each sweep arc's count = its outcomes."""
    recs = flight_snap["records"]
    ticks = [r for r in recs if not r.get("sweep_only")]
    outc = rep.outcomes
    return {
        "ring_holds_run": flight_snap["ticks_recorded"] == len(recs),
        "ticks_recorded_equal_executed": [r["tick"] for r in ticks]
        == list(range(rep.ticks)),
        "tokens_emitted_equal_report": sum(r["tokens_emitted"]
                                           for r in ticks)
        == rep.tokens_generated,
        "last_kv_blocks_used_equal_pool": bool(ticks) and
        ticks[-1]["kv_blocks_used"] == server._pool.used,
        "cancelled_equal_outcomes": sum(r["cancelled"] for r in recs)
        == outc.get("cancelled", 0),
        "deadline_equal_outcomes": sum(r["deadline_expired"] for r in recs)
        == outc.get("deadline", 0),
        "shed_equal_outcomes": sum(r["shed"] for r in recs)
        == outc.get("shed", 0),
    }


def flight_faults(server, prompts, card, out_dir) -> dict:
    """The flight recorder's two planted faults on a 2-request, 8-token
    trace of ``server``: (a) an ``on_token`` callback that sleeps past a
    0.5 s ``stall_after`` (the engine thread stuck inside a tick): the
    endpoint's ``/healthz``, scraped from the callback while it sleeps,
    must answer 503 ``stalled``; (b) a tick that raises: the ``--flight-out``
    dump must exist with reason ``engine_error:...`` and hold the ticks
    before the raise, and the error must reach the caller. ``server`` is
    left mid-run by (b): the caller drops it."""
    from tree_attention_tpu_torch import obs
    from tree_attention_tpu_torch.obs.http import MetricsHTTPServer
    from tree_attention_tpu_torch.serving import Request

    def trace(on_token=None):
        return [Request(uid=700 + i, prompt=prompts[i], max_new_tokens=8,
                        on_token=on_token if i == 0 else None)
                for i in range(2)]

    res = {}
    mhttp = MetricsHTTPServer(0, stall_after=0.5)
    port = mhttp.start()
    mhttp.attach_engine(server)
    obs.FLIGHT.clear()
    obs.FLIGHT.arm(capacity=FLIGHT_CAPACITY)
    seen = []

    def stuck(tok):
        if len(seen) == 2:
            return
        seen.append(_http_get(port, "/healthz"))  # within the stall bound
        if len(seen) == 1:
            time.sleep(0.8)  # the tick wedges past stall_after
            seen.append(_http_get(port, "/healthz"))

    try:
        server.serve(trace(stuck))
        after = _http_get(port, "/healthz")
    finally:
        mhttp.stop()
        obs.FLIGHT.disarm()
    verdicts = [(s, json.loads(b)["status"]) for s, b in seen + [after]]
    res["stall"] = {"healthz": verdicts,
                    "caught": verdicts == [(200, "ok"), (503, "stalled"),
                                           (200, "idle")]}
    # (b) a tick that raises.
    dump = os.path.join(out_dir, "flight_engine_error.json")
    if os.path.exists(dump):
        os.remove(dump)
    step, calls = server._step, [0]

    def boom(*a, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("planted tick fault")
        return step(*a, **kw)

    server._step = boom
    obs.FLIGHT.clear()
    obs.FLIGHT.arm(dump, capacity=FLIGHT_CAPACITY)
    raised = None
    try:
        server.serve(trace())
    except RuntimeError as e:
        raised = str(e)
    finally:
        obs.FLIGHT.disarm()
        del server._step
    data = json.load(open(dump)) if os.path.exists(dump) else {}
    ticks = [r["tick"] for r in data.get("records", [])]
    res["raise"] = {"raised": raised, "reason": data.get("reason"),
                    "ticks": ticks,
                    "caught": raised == "planted tick fault"
                    and str(data.get("reason")).startswith("engine_error:")
                    and len(ticks) >= 2
                    and ticks == list(range(len(ticks)))}
    print(f"flight recorder, planted faults ({card}): a callback wedging "
          f"its tick past stall_after 0.5 s: /healthz {verdicts}; a tick "
          f"that raises: {json.dumps(res['raise'])} (both must be caught)",
          flush=True)
    return res


def ingress_phase(dev, card, serve_args, wrappers, reset_counts, tol_logits,
                  ingress_args=INGRESS_ARGS, deadline_s=0.5) -> dict:
    """Phase 3g: live HTTP serving. An :class:`IngressServer` (port 0 on
    127.0.0.1) over the serve phase's engine (``cli.build_server`` on
    ``serve_args`` + ``ingress_args``), its clients threads of this
    process on ``http.client``:

    (a) the serve phase's 16 prompts, greedy, 8 over SSE and 8 whole
        bodies, all at once, each honouring 429's ``Retry-After``;
    (b) one SSE client that closes its socket after its 4th token;
    (c) one request whose deadline has passed on arrival and one (a short
        prompt, long budget) whose ``deadline_s`` expires in flight;
    (d) a burst of 12 past the queue bound, taking its 429s;
    (e) ``POST /admin/drain`` (202), a POST after it (503), ``join()``;
    (f) the same over ``--kv-quant int8``: one prompt cancelled while it
        stages (``SlotServer.cancel``, the handlers' seam, called on the
        engine thread right after the prompt's first staged chunk, as an
        ``on_token`` callback would), one client gone after its 2nd token,
        two served.

    Gates: every result's tokens within ``tol_logits`` of their position's
    largest logit (:func:`replay_margin`); each SSE stream and whole body
    equal to its result's tokens (a vanished client's read tokens a prefix
    of them); outcomes as scripted; the drained engine leak-free (exact and
    int8); B2's tick body and B3 launched (B5's tick body and B3 under
    int8), read from the wrappers' counts, set to 0 before each ingress
    starts and read after its ``join()``; and the two faults of
    :func:`ingress_faults` rejected. Client TTFT (POST to the first token
    event) and TBT p50/p95, tokens/s, the status counts and the wall are
    printed beside ``card``.

    The telemetry plane (slice 6f): the exact serve (a)-(e) runs with the
    flight recorder armed and a ``MetricsHTTPServer`` (port 0) attached to
    the engine: ``/healthz`` (200 ``ok``), ``/metrics`` and ``/slots``
    scraped mid-serve, ``/healthz`` (200 ``idle``), ``/flight``,
    ``/metrics`` and ``/metrics.json`` after the drain; gated by
    :func:`flight_run_gates` on the ``/flight`` records, the ``/metrics``
    text parsed equal to ``/metrics.json`` sample by sample, and its token
    counter's growth equal to the report's tokens. Before it the trace is
    served statically unarmed and armed (:func:`flight_ab`, and 4 requests
    of it under int8): the same tokens, launches and host reads of the card,
    one fetch per tick that paid one; the tok/s of both printed. Then
    :func:`flight_faults` (a wedged tick seen as 503 ``stalled``, a
    raising tick's ``engine_error`` dump) on that engine."""
    import threading

    import torch

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch import obs
    from tree_attention_tpu_torch.obs import percentile
    from tree_attention_tpu_torch.obs.http import MetricsHTTPServer
    from tree_attention_tpu_torch.serving import (
        IngressServer,
        synthetic_trace,
    )
    from tree_attention_tpu_torch.utils.config import parse_args

    on_card = dev.type == "cuda"
    t_phase = time.monotonic()

    def pctl(vals, p):
        return percentile(sorted(vals), p)

    def start(server, keepalive_s=0.02):
        reset_counts()
        srv = IngressServer(server, max_queue=c.max_queue,
                            default_max_tokens=c.max_new_tokens,
                            keepalive_s=keepalive_s)
        return srv, srv.start()

    def finish(srv):
        """Drain over HTTP, a POST after it, join; the report, the two
        statuses and the launches."""
        d = _http_client(srv.port, {}, path="/admin/drain", stream=False)
        late = _http_client(srv.port, {"prompt": [1, 2], "max_tokens": 2},
                            retry=False)
        rep = srv.join(timeout=300)
        if on_card:
            torch.cuda.synchronize()
        launches = launch_counts(wrappers)
        srv.stop()
        if rep is None:
            fail(f"ingress: the engine did not drain ({srv.engine_error!r})")
        return rep, d["statuses"], late["statuses"], launches

    def check_streams(clients, rep, label):
        """Every client's tokens against its result; returns the results
        by uid."""
        by_uid = {r.uid: r for r in rep.results}
        for cl in clients:
            if cl["uid"] is None:
                continue
            res = list(map(int, by_uid[cl["uid"]].tokens))
            if cl.get("closed"):
                ok = res[:len(cl["tokens"])] == cl["tokens"]
            else:
                ok = res == cl["tokens"]
            if not ok:
                return False, f"{label}: uid {cl['uid']} streamed " \
                    f"{cl['tokens']} but its result holds {res}"
        return True, None

    def margin(server, rep, prompts, quant):
        done = [r for r in rep.results if r.tokens]
        reqs = [types.SimpleNamespace(uid=r.uid, prompt=prompts[r.uid])
                for r in done]
        return replay_margin(server.params, server.cfg, done, reqs, quant,
                             "paged", dev, server.kv_block)

    c = parse_args(serve_args + ingress_args)
    trace = synthetic_trace(
        c.requests, prompt_len=c.prompt_len, prompt_jitter=c.prompt_jitter,
        max_new_tokens=c.max_new_tokens, arrival_every=c.arrival_every,
        vocab_size=c.vocab_size, seed=c.seed + 1)
    prompts = [[int(t) for t in r.prompt] for r in trace]
    n_new = c.max_new_tokens
    out = {"card": card}

    def static_trace(n=None, max_new=n_new):
        return lambda: [dataclasses.replace(r, max_new_tokens=max_new)
                        for r in synthetic_trace(
                            c.requests, prompt_len=c.prompt_len,
                            prompt_jitter=c.prompt_jitter,
                            max_new_tokens=n_new,
                            arrival_every=c.arrival_every,
                            vocab_size=c.vocab_size, seed=c.seed + 1)[:n]]

    def print_ab(ab, label):
        print(f"flight recorder A/B ({label}; {card}): unarmed / armed "
              f"(registry, flight ring, endpoint): tok/s in turns "
              f"{json.dumps(ab['tokens_per_sec'])} (the first, cold, "
              f"untimed; armed over warm unarmed "
              f"{ab['tok_s_armed_over_unarmed']:.4f}; building and "
              f"appending a record {ab['armed']['record_us_per_tick']:.1f} "
              f"us a tick), host reads "
              f"{ab['unarmed']['fetches']} / {ab['armed']['fetches']} "
              f"fetches and {ab['unarmed']['syncs']} / "
              f"{ab['armed']['syncs']} syncs over {ab['armed']['ticks']} "
              f"ticks ({ab['armed']['host_sync_ticks']} paid a fetch), "
              f"launches {json.dumps(ab['unarmed']['launches'])} / "
              f"{json.dumps(ab['armed']['launches'])}; gates "
              f"{json.dumps(ab['gates'])}", flush=True)
        if not all(ab["gates"].values()):
            fail(f"flight recorder A/B ({label}): {ab['gates']}")

    # -- exact: (a)-(e) ----------------------------------------------------
    server, cache_len, _ = cli.build_server(c, dev)
    t_tel = time.monotonic()
    ab = flight_ab(server, static_trace(), wrappers, reset_counts, on_card)
    print_ab(ab, f"exact, the {c.requests}-request trace")
    # The wall this slice's checks add to the phase: the A/B serves, the
    # faults' serves and the scrapes after the drain.
    out["telemetry_wall_s"] = time.monotonic() - t_tel
    # The HTTP serve, armed: the ring, the registry and the endpoint.
    obs.FLIGHT.clear()
    obs.FLIGHT.arm(capacity=FLIGHT_CAPACITY)
    obs.REGISTRY.enable()
    tok0 = obs.REGISTRY.get("serving_tokens_total").value()
    mhttp = MetricsHTTPServer(0)
    mport = mhttp.start()
    mhttp.attach_engine(server)
    live = {}

    def scrape_live():
        """Mid-serve: once the engine is ticking, one scrape of each."""
        t_w = time.monotonic()
        while time.monotonic() - t_w < 300 and not (
                obs.FLIGHT.ticks_recorded >= 2 and not obs.FLIGHT.idle):
            time.sleep(0.002)
        for path in ("/healthz", "/metrics", "/slots"):
            live[path] = _http_get(mport, path)

    scraper = threading.Thread(target=scrape_live, daemon=True)
    srv, port = start(server)
    scraper.start()
    t0 = time.monotonic()
    a = _in_threads([(_http_client, dict(
        port=port, body={"prompt": p, "max_tokens": n_new},
        stream=i % 2 == 0)) for i, p in enumerate(prompts)])
    a_wall = time.monotonic() - t0
    b = _http_client(port, {"prompt": prompts[0], "max_tokens": n_new},
                     close_after=4)
    b["closed"] = True
    short = prompts[1][:16]
    c_late = _in_threads([
        (_http_client, dict(port=port, body={
            "prompt": prompts[2], "max_tokens": n_new, "deadline_s": 1e-6})),
        (_http_client, dict(port=port, body={
            "prompt": short, "max_tokens": cache_len - len(short) - 8,
            "deadline_s": deadline_s}))])
    d = _in_threads([(_http_client, dict(
        port=port, body={"prompt": prompts[i % len(prompts)],
                         "max_tokens": 8}, retry=False))
        for i in range(12)])
    rep, drain_st, late_st, launches = finish(srv)
    scraper.join(60)
    t_tel = time.monotonic()
    after = {path: _http_get(mport, path) for path in (
        "/healthz", "/flight", "/metrics", "/metrics.json")}
    out["telemetry_wall_s"] += time.monotonic() - t_tel
    mhttp.stop()
    obs.REGISTRY.disable()
    obs.FLIGHT.disarm()
    by_prompt = {}
    for cl, p in zip(a, prompts):
        by_prompt[cl["uid"]] = p
    by_prompt[b["uid"]] = prompts[0]
    by_prompt[c_late[0]["uid"]] = prompts[2]
    by_prompt[c_late[1]["uid"]] = short
    for i, cl in enumerate(d):
        if cl["uid"] is not None:
            by_prompt[cl["uid"]] = prompts[i % len(prompts)]
    res = {r.uid: r for r in rep.results}
    ttft = [cl["ttft_s"] for cl in a if cl["ttft_s"] is not None]
    gaps = [g for cl in a for g in cl["gaps_s"]]
    statuses = {}
    for cl in a + [b] + c_late + d:
        for s in cl["statuses"]:
            statuses[str(s)] = statuses.get(str(s), 0) + 1
    toks_a = sum(len(cl["tokens"]) for cl in a)
    # What HTTP adds to TTFT: each SSE client's (POST to first token event)
    # less the engine's own TTFT of the same request (submission to the
    # tick's fetch).
    http_gap = [cl["ttft_s"] - res[cl["uid"]].ttft_s for cl in a
                if cl["ttft_s"] is not None]
    exact = {
        "ttft_p50_s": pctl(ttft, 0.5), "ttft_p95_s": pctl(ttft, 0.95),
        "engine_ttft_p50_s": pctl([res[cl["uid"]].ttft_s for cl in a
                                    if cl["ttft_s"] is not None], 0.5),
        "http_ttft_over_engine_p50_s": pctl(http_gap, 0.5),
        "http_ttft_over_engine_max_s": max(http_gap),
        "tbt_p50_s": pctl(gaps, 0.5), "tbt_p95_s": pctl(gaps, 0.95),
        "tokens_per_sec": toks_a / a_wall, "wave_wall_s": a_wall,
        "client_statuses": statuses,
        "retry_after_s": sorted({r for cl in a + d
                                 for r in cl["retry_after"]}),
        "drain_status": drain_st, "post_after_drain": late_st,
        "outcomes": rep.outcomes, "engine": rep.as_dict(),
        "leaks": server.leak_report(), "launches": launches,
        "replay_margin": margin(server, rep, by_prompt, False),
        "cancelled_tokens": len(res[b["uid"]].tokens),
        "deadline_in_flight_tokens": len(res[c_late[1]["uid"]].tokens),
    }
    out["exact"] = exact
    print(f"ingress (exact, 8 slots, max queue {c.max_queue}; {card}): "
          f"client TTFT p50/p95 {exact['ttft_p50_s']:.4f} / "
          f"{exact['ttft_p95_s']:.4f} s (over the engine's own TTFT of the "
          f"same requests: p50 {exact['http_ttft_over_engine_p50_s']:.4f}, "
          f"max {exact['http_ttft_over_engine_max_s']:.4f} s), TBT p50/p95 "
          f"{exact['tbt_p50_s']:.5f} / {exact['tbt_p95_s']:.5f} s, "
          f"{exact['tokens_per_sec']:.1f} tok/s over the 16-request wave "
          f"({a_wall:.2f} s); statuses {json.dumps(statuses)} (drain "
          f"{drain_st}, a POST after it {late_st}), Retry-After "
          f"{exact['retry_after_s']}; outcomes {json.dumps(rep.outcomes)}; "
          f"leaks {json.dumps(exact['leaks'])}; replay margin "
          f"{exact['replay_margin']:.3e} (tol {tol_logits}); launches "
          f"{json.dumps(launches)}", flush=True)
    ok, why = check_streams(a + [b] + c_late + d, rep, "ingress (exact)")
    if not ok:
        fail(why)
    want = {cl["uid"]: "budget" for cl in a}
    want[b["uid"]] = "cancelled"
    want[c_late[0]["uid"]] = want[c_late[1]["uid"]] = "deadline"
    for cl in d:
        if cl["uid"] is not None:
            want[cl["uid"]] = "budget"
    got = {u: res[u].outcome for u in want}
    if got != want or any(len(res[cl["uid"]].tokens) != n_new for cl in a):
        fail(f"ingress (exact): outcomes {got}, scripted {want}")
    if not (4 <= exact["cancelled_tokens"] < n_new
            and res[c_late[0]["uid"]].admit_tick == -1
            and 1 <= exact["deadline_in_flight_tokens"]
            < cache_len - len(short) - 8):
        fail(f"ingress (exact): cancelled with {exact['cancelled_tokens']} "
             f"tokens, deadline on arrival admitted at "
             f"{res[c_late[0]['uid']].admit_tick}, deadline in flight with "
             f"{exact['deadline_in_flight_tokens']} tokens")
    if not any(429 in cl["statuses"] for cl in d) or not all(
            r >= 1 for cl in d for r in cl["retry_after"]) or \
            drain_st != [202] or late_st != [503]:
        fail(f"ingress (exact): statuses {statuses}, drain {drain_st}, "
             f"POST after the drain {late_st}")
    if not leaks_clean(exact["leaks"]):
        fail(f"ingress (exact) leaked: {exact['leaks']}")
    if not exact["replay_margin"] <= tol_logits:
        fail(f"ingress (exact): an emitted token is "
             f"{exact['replay_margin']} below its position's largest logit")
    if on_card and not (launches.get("flash_decode_paged_tick")
                        and launches["flash_fwd"]):
        fail(f"ingress (exact): launches {launches}")

    # -- the telemetry plane over that serve ---------------------------------
    def status(resp):
        code, body = resp
        try:
            return code, json.loads(body).get("status")
        except ValueError:
            return code, body[:80]

    flight_snap = json.loads(after["/flight"][1])
    fgates = flight_run_gates(rep, flight_snap, server)
    prom_live = parse_prometheus(live["/metrics"][1]) \
        if live.get("/metrics", (0,))[0] == 200 else {}
    prom = parse_prometheus(after["/metrics"][1])
    prom_plain = {k: v for k, v in prom.items()
                  if not k[0].endswith("_bucket")}
    jsamples = json_samples(json.loads(after["/metrics.json"][1]))
    slots_live = json.loads(live["/slots"][1]) \
        if live.get("/slots", (0,))[0] == 200 else []
    fgates.update({
        "healthz_live_ok": status(live.get("/healthz", (0, "")))
        == (200, "ok"),
        "healthz_after_idle": status(after["/healthz"]) == (200, "idle"),
        "metrics_live_parsed": ("serving_tokens_total", ()) in prom_live,
        "slots_live": len(slots_live) == c.slots,
        "metrics_equal_metrics_json": prom_plain == jsamples,
        "token_counter_equal_report": prom.get(("serving_tokens_total",
                                                ())) - tok0
        == rep.tokens_generated,
    })
    recs = flight_snap["records"]
    exact["flight"] = {
        "gates": fgates, "ab": ab,
        "ticks_recorded": flight_snap["ticks_recorded"],
        "executed_ticks": rep.ticks,
        "sweep_only": sum(1 for r in recs if r.get("sweep_only")),
        "arcs": {k: sum(r[k] for r in recs)
                 for k in ("cancelled", "deadline_expired", "shed")},
        "host_sync_ticks": sum(1 for r in recs if r.get("host_sync")),
        "healthz": [status(live.get("/healthz", (0, ""))),
                    status(after["/healthz"])],
        "metrics_series": len(prom), "armed_launches": launches,
    }
    print(f"flight recorder (exact HTTP serve, armed; {card}): ticks "
          f"recorded {flight_snap['ticks_recorded']} = executed "
          f"{rep.ticks} + {exact['flight']['sweep_only']} sweep-only; "
          f"arcs {json.dumps(exact['flight']['arcs'])} against outcomes "
          f"{json.dumps(rep.outcomes)}; /healthz "
          f"{exact['flight']['healthz']}; /metrics {len(prom)} series "
          f"({len(jsamples)} in /metrics.json); launches "
          f"{json.dumps(launches)}; gates {json.dumps(fgates)}", flush=True)
    if not all(fgates.values()):
        fail(f"flight recorder (exact HTTP serve): {fgates}")

    # -- the gates' teeth: a leaking cancel, a swapped streamed token ------
    teeth = {}
    for fault in ("leak", "swap"):
        with ingress_faults(fault):
            srv, port = start(server)
            cl = _http_client(port, {"prompt": prompts[3],
                                     "max_tokens": 16},
                              close_after=2 if fault == "leak" else None)
            cl["closed"] = fault == "leak"
            frep = finish(srv)[0]
        if fault == "leak":
            lr = server.leak_report()
            teeth[fault] = {"leaks": lr, "rejected": not leaks_clean(lr)}
        else:
            okf, why = check_streams([cl], frep, "planted swap")
            teeth[fault] = {"rejected": not okf, "why": why}
        print(f"ingress, planted fault {fault!r}: {json.dumps(teeth[fault])}"
              f" (the gate must reject it)", flush=True)
        if not teeth[fault]["rejected"]:
            fail(f"ingress: the gate passed the planted fault {fault!r}")
    out["faults"] = teeth
    # The flight recorder's planted faults (the last serves of this engine:
    # the raising tick leaves it mid-run).
    t_tel = time.monotonic()
    out["flight_faults"] = flight_faults(
        server, prompts, card, "chiprun_out" if on_card else
        os.environ.get("TMPDIR", "/tmp"))
    out["telemetry_wall_s"] += time.monotonic() - t_tel
    for fault, r in out["flight_faults"].items():
        if not r["caught"]:
            fail(f"flight recorder: the planted fault {fault!r} was not "
                 f"caught: {r}")
    del server, srv
    if on_card:
        torch.cuda.empty_cache()

    # -- (f) int8 -----------------------------------------------------------
    c8 = parse_args(serve_args + ingress_args + ["--kv-quant", "int8"])
    server, _, _ = cli.build_server(c8, dev)
    t_tel = time.monotonic()
    ab8 = flight_ab(server, static_trace(4, 16), wrappers, reset_counts,
                    on_card)
    print_ab(ab8, "int8, 4 requests of the trace, 16 new tokens")
    out["telemetry_wall_s"] += time.monotonic() - t_tel
    srv, port = start(server)
    staged = {}
    run_staged = server._run_staged_chunk

    def staged_then_cancel(slot, n, last):
        """The first staged prompt is cancelled after its first chunk: the
        next sweep retires it mid-stage."""
        run_staged(slot, n, last)
        if not staged and not last:
            staged.update(server.slots_snapshot()[slot])
            server.cancel(staged["uid"])

    server._run_staged_chunk = staged_then_cancel
    f1 = _http_client(port, {"prompt": prompts[4], "max_tokens": 16})
    del server._run_staged_chunk
    f2 = _http_client(port, {"prompt": prompts[5], "max_tokens": n_new},
                      close_after=2)
    f2["closed"] = True
    f3 = _in_threads([(_http_client, dict(
        port=port, body={"prompt": prompts[i], "max_tokens": 16},
        stream=i % 2 == 0)) for i in (6, 7)])
    rep8, drain8, late8, launches8 = finish(srv)
    res8 = {r.uid: r for r in rep8.results}
    prom8 = {f1["uid"]: prompts[4], f2["uid"]: prompts[5],
             f3[0]["uid"]: prompts[6], f3[1]["uid"]: prompts[7]}
    int8 = {
        "staged_cancel": {"uid": f1["uid"], "snapshot": staged,
                          "outcome": res8[f1["uid"]].outcome,
                          "tokens": len(res8[f1["uid"]].tokens),
                          "admit_tick": res8[f1["uid"]].admit_tick},
        "tick_cancel_tokens": len(res8[f2["uid"]].tokens),
        "outcomes": rep8.outcomes, "engine": rep8.as_dict(),
        "leaks": server.leak_report(), "launches": launches8,
        "drain_status": drain8, "post_after_drain": late8,
        "replay_margin": margin(server, rep8, prom8, True),
        "flight_ab": ab8,
    }
    out["int8"] = int8
    print(f"ingress (int8; {card}): staged cancel "
          f"{json.dumps(int8['staged_cancel'])}; client gone after 2 tokens "
          f"retired with {int8['tick_cancel_tokens']}; outcomes "
          f"{json.dumps(rep8.outcomes)}; leaks {json.dumps(int8['leaks'])}; "
          f"replay margin {int8['replay_margin']:.3e}; launches "
          f"{json.dumps(launches8)}", flush=True)
    ok, why = check_streams([f1, f2] + f3, rep8, "ingress (int8)")
    if not ok:
        fail(why)
    want8 = {f1["uid"]: "cancelled", f2["uid"]: "cancelled",
             f3[0]["uid"]: "budget", f3[1]["uid"]: "budget"}
    if {u: res8[u].outcome for u in want8} != want8 or \
            staged.get("uid") != f1["uid"] or res8[f1["uid"]].tokens or \
            res8[f1["uid"]].admit_tick < 0 or \
            not 2 <= int8["tick_cancel_tokens"] < n_new:
        fail(f"ingress (int8): {json.dumps(int8['staged_cancel'])}, "
             f"outcomes {rep8.outcomes}, scripted {want8}")
    if not leaks_clean(int8["leaks"]):
        fail(f"ingress (int8) leaked: {int8['leaks']}")
    if not int8["replay_margin"] <= tol_logits:
        fail(f"ingress (int8): an emitted token is "
             f"{int8['replay_margin']} below its position's largest logit")
    if on_card and not (launches8.get("flash_decode_paged_q8q_tick")
                        and launches8["flash_fwd"]):
        fail(f"ingress (int8): launches {launches8}")
    del server, srv
    out["wall_s"] = time.monotonic() - t_phase
    print(f"ingress phase wall {out['wall_s']:.2f}s, of which the flight "
          f"recorder's A/B serves, faults and scrapes "
          f"{out['telemetry_wall_s']:.2f}s ({card})", flush=True)
    return out


WHOLE_ARGS = ["--admission", "whole"]
# Phase 3h (a): the five whole-admission serves of the serve phase's trace:
# (flags beside it, layout, q8 route, prefix cache on).
WHOLE_SERVES = {
    "exact paged": ([], "paged", None, False),
    "int8 paged (B5)": (["--kv-quant", "int8"], "paged", "q8q", False),
    "exact contiguous (B1)": (["--kv-layout", "contiguous", "--requests",
                               "8", "--slots", "4"], "contiguous", None,
                              False),
    "exact paged, prefix cache": (PREFIX_ARGS, "paged", None, True),
    "exact paged, speculative": (["--speculate", "--drafter", "ngram",
                                  "--draft-k", "4"], "paged", None, False),
}
# Phase 3h (b): the tier's engine: 2 slots of 512-token prompts and 32 new
# tokens (9 blocks of 64 each), a 34-block pool (the slots' 18 beside two
# prompts' 8 published blocks each), a 64-block host tier.
TIER_ARGS = ["--slots", "2", "--prompt-len", "512", "--prompt-jitter", "0",
             "--max-new-tokens", "32", "--prefix-cache", "--kv-blocks", "34",
             "--host-blocks", "64"]
TIER_PREFIXES, TIER_PREFIX_LEN = 8, 384


@contextlib.contextmanager
def shared_weights():
    """Draw the serving model's weights once per (config, seed, device)
    for the serves inside: every ``cli.build_server`` draws the same
    weights from the same seed, and at the serve width the numpy draw
    takes seconds. Serving never writes the weights; training does, and
    runs outside."""
    from tree_attention_tpu_torch import models

    draw, memo = models.init_params, {}

    def drawn(cfg, seed=0, device="cuda"):
        key = (repr(cfg), seed, str(device))
        if key not in memo:
            memo[key] = draw(cfg, seed, device)
        return memo[key]

    models.init_params = drawn
    try:
        yield
    finally:
        models.init_params = draw


def launch_counts(wrappers) -> dict:
    """Every wrapper's launches, and its per-body counts where non-zero
    (``<name>_tick``, ``_tiled``, ``_cast_tiled``, ``_tree``)."""
    c = {n: w.launches for n, w in wrappers.items()}
    for n, w in wrappers.items():
        for extra in ("tiled_launches", "tick_launches",
                      "cast_tiled_launches", "tree_launches"):
            if getattr(w, extra, 0):
                c[n + "_" + extra.replace("_launches", "")] = getattr(w,
                                                                      extra)
    return c


@contextlib.contextmanager
def whole_watch():
    """Watch whole admission from outside the engine: the prefill buckets,
    the prompt chunks consumed (cold whole prefills consume none), and the
    (Tq, Tk) of every B3 call. ``fault`` ``"insert"`` plants an insert that
    writes the prompt one block off in the slot's table row (block ``j``'s
    rows land in the table's entry ``j + 1``)."""
    from tree_attention_tpu_torch.ops import decode as decode_ops
    from tree_attention_tpu_torch.serving import engine

    seen = {"buckets": [], "chunks": 0, "b3": {}, "fault": None}
    cls = engine.SlotServer
    prefill, consume = cls._prefill, cls._consume_chunk
    insert, fwd = engine.paged_insert_slot, decode_ops.attention_cuda_fwd

    def prefilled(self, slot, prompt):
        mini = prefill(self, slot, prompt)
        seen["buckets"].append(mini.k.shape[3])
        return mini

    def counted(self, slot, n, last):
        seen["chunks"] += 1
        return consume(self, slot, n, last)

    def shifted(cache, slot, *args, **kw):
        if seen["fault"] != "insert":
            return insert(cache, slot, *args, **kw)
        row = cache.table[slot].clone()
        cache.table[slot, 1:] = row[:-1]
        try:
            return insert(cache, slot, *args, **kw)
        finally:
            cache.table[slot] = row

    def b3(q, k, v, *args, **kw):
        key = f"{q.shape[2]}x{k.shape[2]}"
        seen["b3"][key] = seen["b3"].get(key, 0) + 1
        return fwd(q, k, v, *args, **kw)

    cls._prefill, cls._consume_chunk = prefilled, counted
    engine.paged_insert_slot, decode_ops.attention_cuda_fwd = shifted, b3
    try:
        yield seen
    finally:
        cls._prefill, cls._consume_chunk = prefill, consume
        engine.paged_insert_slot, decode_ops.attention_cuda_fwd = insert, fwd


@contextlib.contextmanager
def tier_watch():
    """Watch the host tier from outside the engine: the bytes (K, V; int8
    codes with their scales) of every block the paged index adopted, read
    at adoption and keyed by radix node (a restore moves a node to a new
    block and its bytes must come with it), and the blocks each copy moves
    (``d2h_blocks``: the flushes' rows; ``h2d_blocks``: the restores' rows,
    padding included). ``fault`` plants one of two
    faults: ``"reverse"`` — a restore that scatters its host rows in reverse
    order (a permutation of whole blocks that every query sees: attention
    is blind to it, since each key carries its rotary position, so only the
    bytes gate can reject it); ``"skip"`` — a restore whose scatter never
    runs (the fresh blocks keep a former occupant's bytes)."""
    import torch

    from tree_attention_tpu_torch.models import gather_kv_blocks
    from tree_attention_tpu_torch.serving import engine, host_pool

    seen = {"nodes": {}, "fault": None, "d2h_blocks": 0, "h2d_blocks": 0}
    cls, pool = engine.SlotServer, host_pool.HostBlockPool
    publish, read, commit = cls._publish_prefix, pool.read, pool.commit
    scatter = engine.scatter_kv_blocks

    def snapped(self, slot):
        held = {id(x) for x in self._slot_nodes[slot]}
        publish(self, slot)
        new = [x for x in self._slot_nodes[slot] if id(x) not in held]
        if new:
            c = self.cache
            parts = gather_kv_blocks(
                c.k, c.v, torch.tensor([x.block_id for x in new]),
                *((c.k_scale, c.v_scale) if self.quantize else ()))
            for i, x in enumerate(new):
                seen["nodes"][id(x)] = (x, [p[i].clone() for p in parts])

    def reversed_rows(self, rows, pad_to=None):
        if seen["fault"] == "reverse":
            rows = list(rows)[::-1]
        out = read(self, rows, pad_to)
        seen["h2d_blocks"] += out[0].shape[0]
        return out

    def counted(self, rows, *args):
        seen["d2h_blocks"] += len(rows)
        return commit(self, rows, *args)

    def skipped(*args):
        if seen["fault"] != "skip":
            return scatter(*args)

    cls._publish_prefix, pool.read, pool.commit = (snapped, reversed_rows,
                                                   counted)
    engine.scatter_kv_blocks = skipped
    try:
        yield seen
    finally:
        cls._publish_prefix, pool.read, pool.commit = publish, read, commit
        engine.scatter_kv_blocks = scatter


def tier_bytes_changed(server, seen) -> tuple:
    """``(changed, checked)``: of the adopted nodes still in the tree on the
    device tier, how many blocks hold other bytes (and scales) than at
    adoption; host-tier nodes are read from their host rows."""
    import torch

    from tree_attention_tpu_torch.models import gather_kv_blocks
    from tree_attention_tpu_torch.serving import TIER_DEVICE

    live = set()
    stack = list(server._prefix._root.children.values())
    while stack:
        node = stack.pop()
        stack.extend(node.children.values())
        live.add(id(node))
    c, hp = server.cache, server._host_pool
    changed = checked = 0
    for key, (node, snap) in seen["nodes"].items():
        if key not in live:
            continue
        if node.tier == TIER_DEVICE:
            parts = [p[0] for p in gather_kv_blocks(
                c.k, c.v, torch.tensor([node.block_id]),
                *((c.k_scale, c.v_scale) if server.quantize else ()))]
        else:
            parts = [p[node.block_id] for p in hp._parts()]
        checked += 1
        changed += not all(torch.equal(p.to(s.device), s)
                           for p, s in zip(parts, snap))
    return changed, checked


def tier_trace(n: int, seed: int, vocab: int):
    """``n`` requests of the tier trace: request ``i`` opens on the ``i %
    8``-th of 8 fixed 384-token prefixes (one seed for every pass), then a
    128-token suffix of its own (``seed``)."""
    from tree_attention_tpu_torch.serving import synthetic_trace

    return synthetic_trace(
        n, prompt_len=512, prompt_jitter=0, max_new_tokens=32,
        vocab_size=vocab, seed=seed, prefix_share=1.0,
        prefix_len=TIER_PREFIX_LEN, prefix_count=TIER_PREFIXES,
        prefix_seed=99)


def d2h_copies(prof, cuda_dev) -> dict:
    """Device memcpy events of a trace by kind (name, e.g. ``Memcpy DtoH
    (Device -> Pinned)``): count and summed ms."""
    out = {}
    for e in prof.events():
        if e.device_type == cuda_dev and e.name.startswith("Memcpy"):
            n, ms = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, ms + e.time_range.elapsed_us() / 1e3)
    return {k: {"count": n, "ms": ms} for k, (n, ms) in out.items()}


def whole_tier_phase(dev, card, serve_args, wrappers, reset_counts,
                     tol_logits, split_by=None,
                     groups=None, whole_serves=WHOLE_SERVES,
                     tier_args=TIER_ARGS,
                     faults=("insert", "reverse", "skip")) -> dict:
    """Phase 3h: whole-prompt admission and the host-RAM KV tier at the
    serve width.

    (a) The serve phase's trace through ``cli.run_serve`` with
        ``--admission whole``, the five ``WHOLE_SERVES``. Gates: every
        request retires with its budget and the pools drain; every emitted
        greedy token within ``tol_logits`` of its position's largest logit
        (:func:`replay_margin`); B3 once per layer per cold admission at Tq
        = Tk = its bucket and no prefill chunk where nothing is cached; the
        one-row paged ticks on the tick body (B2; B5 under int8); in a
        traced 8-request wave, no more D2H copies than ticks (one fetch a
        tick, none at admission), beside the chunked wave's. The planted
        fault ``"insert"`` (:func:`whole_watch`) must fail the replay gate.
        Reported beside the chunked serve of the same trace, run first in
        this phase (a warm process, as the whole serves find it): TTFT and
        TBT p50/p95, tok/s; a lone 512-token request's TTFT, whole and
        chunked (median of three, alternating).
    (b) The tier: ``cli.build_server`` on ``serve_args`` + ``tier_args``
        (exact, then ``--kv-quant int8``), pass 1 the 8 prefixes of
        :func:`tier_trace` cold, pass 2 the same prefixes in the same order
        with new suffixes (the LRU worst case). Gates: pass 1 demotes;
        every pass-2 request hits its whole prefix and restores happen;
        every block the index adopted holds its adoption bytes (and
        scales) wherever it lives now (:func:`tier_bytes_changed`); the
        replay gate over both passes; the pools drain with nothing staged.
        Of the planted faults of :func:`tier_watch`, ``"reverse"`` must
        fail the bytes gate (the replay gate cannot see a permutation of
        visible blocks; its margin is reported) and ``"skip"`` both gates.
        Reported: pass-2 TTFT p50 with the
        tier, with ``--kv-tiering off`` (cold recompute) and with a pool
        that keeps everything on the device; blocks demoted and restored;
        the pinned bytes; a third pass traced: the tier's D2H and H2D
        copies (ms, GB/s) and the serve's idle share.

    Launch counts are set to 0 just before each serve and read just after.
    The serves share one draw of the weights (:func:`shared_weights`).
    ``card`` (the card's name and power limit) heads each line. On a CPU
    the launch counts and the traces are not read."""
    with shared_weights():
        return _whole_tier_phase(dev, card, serve_args, wrappers,
                                 reset_counts, tol_logits, split_by, groups,
                                 whole_serves, tier_args, faults)


def _whole_tier_phase(dev, card, serve_args, wrappers, reset_counts,
                      tol_logits, split_by, groups, whole_serves, tier_args,
                      faults) -> dict:
    import torch

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.serving import (
        Request,
        SlotServer,
        synthetic_trace,
    )
    from tree_attention_tpu_torch.utils.config import parse_args

    on_card = dev.type == "cuda"
    cuda_dev = torch.autograd.DeviceType.CUDA

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def trace_of(c, vocab):
        return synthetic_trace(
            c.requests, prompt_len=c.prompt_len,
            prompt_jitter=c.prompt_jitter, max_new_tokens=c.max_new_tokens,
            arrival_every=c.arrival_every, vocab_size=vocab,
            seed=c.seed + 1, prefix_share=c.prefix_share,
            prefix_len=c.prefix_len)

    def margin(server, results, reqs, layout, route):
        return replay_margin(server.params, server.cfg, results, reqs,
                             route is not None, layout, dev,
                             server.kv_block if layout == "paged" else 64,
                             route or "q8q")

    def lat(rep):
        return {k: round(v, 5) for k, v in rep.latency_percentiles().items()}

    out = {"whole": {}, "tier": {}, "faults": {}}
    # -- (a) whole admission ------------------------------------------------
    # The chunked serve of the same trace first: the yardstick.
    crec, _, _ = cli.run_serve(parse_args(serve_args), dev)
    sync()
    out["chunked"] = {k: crec[k] for k in (
        "tokens_per_sec", "ttft_p50_s", "ttft_p95_s", "tbt_p50_s",
        "tbt_p95_s", "wall_s")}
    for label, (flags, layout, route, cached) in whole_serves.items():
        argv = serve_args + WHOLE_ARGS + flags
        c = parse_args(argv)
        with whole_watch() as seen:
            reset_counts()
            rec, server, rep = cli.run_serve(c, dev)
            sync()
            launches = launch_counts(wrappers)
        reqs = trace_of(c, server.cfg.vocab_size)
        n_req, n_new, L = c.requests, c.max_new_tokens, server.cfg.n_layers
        leaks = server.leak_report()
        big = sum(b for b in seen["buckets"] if b >= 128)
        r = {"record": {k: rec[k] for k in (
                 "tokens_per_sec", "ttft_p50_s", "ttft_p95_s", "tbt_p50_s",
                 "tbt_p95_s", "wall_s", "ticks", "steps")},
             "prefill_buckets": sorted(seen["buckets"]),
             "chunks": seen["chunks"], "b3_tq_x_tk": seen["b3"],
             "launches": launches, "leaks": leaks,
             "prefix": rep.prefix, "spec": rep.spec,
             "replay_margin": margin(server, rep.results, reqs, layout,
                                     route)}
        out["whole"][label] = r
        print(f"whole serve ({label}; {card}): {rec['tokens_per_sec']} tok/s"
              f", ttft p50 {rec['ttft_p50_s']} p95 {rec['ttft_p95_s']} s, "
              f"tbt p50 {rec['tbt_p50_s']} p95 {rec['tbt_p95_s']} s; "
              f"prefills by bucket {sorted(seen['buckets'])}, chunks "
              f"{seen['chunks']}, B3 calls by Tq x Tk "
              f"{json.dumps(seen['b3'])}; replay margin "
              f"{r['replay_margin']:.3e} (tol {tol_logits}); leaks "
              f"{json.dumps(leaks)}; launches {json.dumps(launches)}",
              flush=True)
        if rep.outcomes != {"budget": n_req} or \
                rep.tokens_generated != n_req * n_new:
            fail(f"whole serve ({label}): outcomes {rep.outcomes}, "
                 f"{rep.tokens_generated} tokens")
        if not leaks_clean(leaks) or (not cached and leaks["blocks_used"]):
            fail(f"whole serve ({label}) leaked: {leaks}")
        if not r["replay_margin"] <= tol_logits:
            fail(f"whole serve ({label}): an emitted token is "
                 f"{r['replay_margin']} below its position's largest logit")
        cold = len(seen["buckets"])
        if not cached and (cold != n_req or seen["chunks"]):
            fail(f"whole serve ({label}): {cold} whole prefills and "
                 f"{seen['chunks']} prompt chunks for {n_req} cold prompts")
        if any(b < 128 for b in seen["buckets"]) or not all(
                f"{b}x{b}" in seen["b3"] for b in seen["buckets"]):
            fail(f"whole serve ({label}): prefill buckets "
                 f"{seen['buckets']}, B3 calls {seen['b3']}")
        if on_card:
            tick = {(None, "paged"): "flash_decode_paged",
                    ("q8q", "paged"): "flash_decode_paged_q8q",
                    (None, "contiguous"): "flash_decode"}[(route, layout)]
            prefills = sum(n for k, n in seen["b3"].items()
                           if k.split("x")[0] == k.split("x")[1])
            off_tick = (launches[tick] - launches.get(tick + "_tick", 0)
                        - launches.get(tick + "_tiled", 0))
            if launches["flash_fwd"] != sum(seen["b3"].values()) or \
                    prefills < L * cold or not launches[tick] or (
                    layout == "paged" and (
                        off_tick or not launches.get(tick + "_tick"))):
                fail(f"whole serve ({label}): launches {launches}, B3 "
                     f"calls {seen['b3']} for {cold} cold prefills")
            if not cached and launches["flash_fwd"] != L * cold:
                fail(f"whole serve ({label}): B3 launched "
                     f"{launches['flash_fwd']} times, not {L} x {cold}")
        if label == "exact paged":
            params, cfg = server.params, server.cfg
            engine_kw = dict(slots=c.slots, cache_len=server.cache_len,
                             prefill_chunk=c.prefill_chunk,
                             kv_block=server.kv_block)
        del server
    for fault in faults[:1]:
        c = parse_args(serve_args + WHOLE_ARGS + ["--requests", "8"])
        with whole_watch() as seen:
            seen["fault"] = fault
            _, server, rep = cli.run_serve(c, dev)
        m = margin(server, rep.results, trace_of(c, server.cfg.vocab_size),
                   "paged", None)
        out["faults"][fault] = {"replay_margin": m}
        print(f"whole serve, planted fault {fault!r}: replay margin "
              f"{m:.3e} (the gate, {tol_logits}, must reject it)", flush=True)
        if m <= tol_logits:
            fail(f"whole serve: the gate passed the planted fault {fault!r}")
        del server
    # A lone request of the trace's prompt length (512) alone: its TTFT,
    # whole against chunked (warm engines, alternating, median of three).
    c0 = parse_args(serve_args)
    rng = __import__("numpy").random.default_rng(5)
    lone = rng.integers(0, cfg.vocab_size, c0.prompt_len).astype("int32")
    engines = {adm: SlotServer(params, cfg, admission=adm, **engine_kw)
               for adm in ("whole", "chunked")}
    ttft = {adm: [] for adm in engines}
    for i in range(4):
        for adm, eng in engines.items():
            res = eng.serve([Request(uid=i, prompt=lone,
                                     max_new_tokens=1)]).results[0]
            if i:  # the first serve of each warms it up
                ttft[adm].append(res.ttft_s)
    out["lone_ttft_s"] = {adm: sorted(v)[1] for adm, v in ttft.items()}
    # One traced 8-request wave per admission: D2H copies against ticks.
    wave = synthetic_trace(8, prompt_len=c0.prompt_len,
                           prompt_jitter=c0.prompt_jitter,
                           max_new_tokens=c0.max_new_tokens,
                           vocab_size=cfg.vocab_size, seed=7)
    out["waves"] = {}
    for adm, eng in engines.items():
        if not on_card:
            break
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            wrep = eng.serve(wave)
            sync()
        copies = d2h_copies(prof, cuda_dev)
        d2h = sum(v["count"] for k, v in copies.items() if "DtoH" in k)
        w = {"ticks": wrep.ticks, "d2h_copies": d2h, "copies": copies}
        if split_by is not None:
            split, _ = split_by(prof, groups)
            busy = sum(split.values())
            w.update(device_busy_ms=busy, traced_wall_ms=wrep.wall_s * 1e3,
                     by_group_ms=split)
        out["waves"][adm] = w
    del engines
    print(f"whole admission ({card}): lone {c0.prompt_len}-token request "
          f"TTFT whole / chunked {out['lone_ttft_s']['whole']:.4f} / "
          f"{out['lone_ttft_s']['chunked']:.4f} s; serve whole / "
          f"chunked ttft p50 "
          f"{out['whole']['exact paged']['record']['ttft_p50_s']} / "
          f"{crec['ttft_p50_s']} s, tok/s "
          f"{out['whole']['exact paged']['record']['tokens_per_sec']} / "
          f"{crec['tokens_per_sec']}; traced 8-request waves: "
          + json.dumps({a: {k: w[k] for k in w if k != "copies"}
                        for a, w in out["waves"].items()}), flush=True)
    for adm, w in out["waves"].items():
        if adm == "whole" and w["d2h_copies"] > w["ticks"]:
            fail(f"whole admission: {w['d2h_copies']} D2H copies in "
                 f"{w['ticks']} ticks (more than the tick's one fetch)")

    # -- (b) the host-RAM KV tier ---------------------------------------------
    def tier_run(flags, passes=2, fault=None, traced=False):
        c = parse_args(serve_args + tier_args + flags)
        with tier_watch() as seen:
            seen["fault"] = fault
            server, _, _ = cli.build_server(c, dev)
            vocab = server.cfg.vocab_size
            reps, trs, counts = [], [], []
            for p in range(passes):
                tr = tier_trace(TIER_PREFIXES, 200 + p, vocab)
                reset_counts()
                if traced and p == passes - 1 and on_card:
                    seen["d2h_blocks"] = seen["h2d_blocks"] = 0
                    with torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                        reps.append(server.serve(tr))
                        sync()
                    seen["prof"] = prof
                else:
                    reps.append(server.serve(tr))
                    sync()
                counts.append(launch_counts(wrappers))
                trs.append(tr)
            changed = (tier_bytes_changed(server, seen)
                       if server._host_pool is not None else (0, 0))
        return server, reps, trs, counts, changed, seen

    tier_kv = ("demotions", "restores", "host_drops", "host_blocks_used")
    for label, flags in (("exact", []), ("int8", ["--kv-quant", "int8"])):
        route = "q8q" if flags else None
        server, reps, trs, counts, (changed, checked), _ = tier_run(flags)
        hits2 = [x.prefix_hit_tokens for x in reps[1].results]
        m = max(margin(server, rep.results, tr, "paged", route)
                for rep, tr in zip(reps, trs))
        hp, leaks = server._host_pool, server.leak_report()
        r = {"passes": [{"record": {**lat(rep), "tokens_per_sec": round(
                 rep.tokens_per_sec, 1), "wall_s": round(rep.wall_s, 4)},
                         "kv": {k: rep.kv.get(k) for k in tier_kv},
                         "prefix": rep.prefix} for rep in reps],
             "pass2_hit_tokens": hits2, "bytes_changed": changed,
             "bytes_checked": checked, "replay_margin": m, "leaks": leaks,
             "pending_after_drain": len(hp.pending),
             "pinned_bytes": hp.nbytes, "pinned": hp.k.is_pinned(),
             "launches": counts}
        out["tier"][label] = r
        print(f"tiered serve ({label}; {card}): pass 1 / 2 "
              f"{json.dumps([p['kv'] for p in r['passes']])}, pass-2 ttft "
              f"p50 {r['passes'][1]['record']['ttft_p50_s']} s, hit tokens "
              f"{hits2}; adopted blocks changed {changed} of {checked}; "
              f"replay margin {m:.3e} (tol {tol_logits}); host tier "
              f"{hp.nbytes / 2**20:.1f} MiB pinned {r['pinned']}; leaks "
              f"{json.dumps(leaks)}; launches pass 2 {json.dumps(counts[1])}",
              flush=True)
        if any(rep.outcomes != {"budget": TIER_PREFIXES} for rep in reps):
            fail(f"tiered serve ({label}): outcomes "
                 f"{[rep.outcomes for rep in reps]}")
        if not reps[0].kv["demotions"] or not reps[1].kv["restores"] or \
                hits2 != [TIER_PREFIX_LEN] * TIER_PREFIXES:
            fail(f"tiered serve ({label}): pass 1 kv {reps[0].kv}, pass 2 "
                 f"kv {reps[1].kv}, hit tokens {hits2}")
        if changed or not checked:
            fail(f"tiered serve ({label}): {changed} of {checked} adopted "
                 f"blocks changed")
        if not m <= tol_logits:
            fail(f"tiered serve ({label}): replay margin {m}")
        if not leaks_clean(leaks) or hp.pending or (on_card and not
                                                   r["pinned"]):
            fail(f"tiered serve ({label}): leaks {leaks}, pending "
                 f"{hp.pending}, pinned {r['pinned']}")
        if on_card:
            tick = "flash_decode_paged_q8q" if route else "flash_decode_paged"
            if any(not n.get(tick + "_tick") or n[tick] != n.get(
                    tick + "_tick", 0) + n.get(tick + "_tiled", 0)
                    for n in counts):
                fail(f"tiered serve ({label}): launches {counts}")
        del server
    # The same trace with the tier off (cold recompute), with a pool that
    # keeps everything, and a third pass traced (the tier's copies).
    for label, flags in (("tiering off", ["--kv-tiering", "off"]),
                         ("device pool keeps all", ["--kv-tiering", "off",
                                                    "--kv-blocks", "98"])):
        _, reps, _, _, _, _ = tier_run(flags)
        out["tier"][label] = {"passes": [
            {"record": lat(rep), "prefix": rep.prefix} for rep in reps]}
    server, reps, _, _, _, seen = tier_run([], passes=3, traced=True)
    if on_card:
        prof = seen.pop("prof")
        copies = d2h_copies(prof, cuda_dev)
        blk = (2 * server.cfg.n_layers * server.cfg.n_kv_heads
               * server.kv_block * server.cfg.d_head
               * server.cfg.dtype.itemsize)
        kv = reps[2].kv
        tiered = {"copies": copies, "block_bytes": blk, "pass3_kv": kv}
        for kind, blocks in (("DtoH (Device -> Pinned)", seen["d2h_blocks"]),
                             ("HtoD (Pinned -> Device)", seen["h2d_blocks"])):
            e = copies.get(f"Memcpy {kind}")
            if e and blocks:
                tiered[kind] = {"ms": e["ms"], "count": e["count"],
                                "blocks": blocks,
                                "gb_per_s": blocks * blk / e["ms"] / 1e6}
        if split_by is not None:
            split, _ = split_by(prof, groups)
            busy = sum(split.values())
            wall = reps[2].wall_s * 1e3
            tiered.update(device_busy_ms=busy, traced_wall_ms=wall,
                          untraced_pass2_wall_ms=reps[1].wall_s * 1e3,
                          idle_share=1 - busy / (reps[1].wall_s * 1e3)
                          if busy else None)
        out["tier"]["traced pass 3"] = tiered
    del server
    for fault in faults[1:]:
        server, reps, trs, _, (changed, checked), _ = tier_run(
            [], fault=fault)
        m = max(margin(server, rep.results, tr, "paged", None)
                for rep, tr in zip(reps, trs))
        out["faults"][fault] = {"replay_margin": m,
                                "bytes_changed": changed,
                                "bytes_checked": checked}
        print(f"tiered serve, planted fault {fault!r}: adopted blocks "
              f"changed {changed} of {checked}, replay margin {m:.3e} (the "
              f"bytes gate must reject it"
              + ("; the replay gate too)" if fault == "skip" else ")"),
              flush=True)
        if not changed or (fault == "skip" and m <= tol_logits):
            fail(f"tiered serve: a gate passed the planted fault {fault!r} "
                 f"(changed {changed}, margin {m})")
        del server
    t = out["tier"]
    print(f"tiered serve ({card}): pass-2 ttft p50 tier on / off / device "
          f"pool keeps all {t['exact']['passes'][1]['record']['ttft_p50_s']}"
          f" / {t['tiering off']['passes'][1]['record']['ttft_p50_s']} / "
          f"{t['device pool keeps all']['passes'][1]['record']['ttft_p50_s']}"
          f" s; traced pass 3: "
          + json.dumps({k: v for k, v in t.get("traced pass 3", {}).items()
                        if k != "copies"}), flush=True)
    return out


# The planted faults phase 3i must reject (fork_watch): a fork whose tail
# copy is skipped; a child whose table names the parent's partial tail
# block instead of its copy; a child that shares the partial tail block by
# refcount (an off-by-one of ``nshare``), so both branches append into it.
FORK_FAULTS = ("skip_copy", "parent_tail", "share_tail")


@contextlib.contextmanager
def fork_watch(fault=None):
    """Watch copy-on-write forks from outside the engine:

    - the prompt tokens the serves' chunks consume;
    - every tail copy: ``(src, dst)``, and whether ``dst`` holds ``src``'s
      bytes (and block scales) after it;
    - the ownership gate after each fork: a block that two live tables
      name must be a shared ancestor (refcounted or radix-cached);
    - the bytes gate: the K/V bytes (and scales) of every shared ancestor
      block at fork time, compared at the family's last retire.

    ``fault`` plants one of :data:`FORK_FAULTS`."""
    import torch

    from tree_attention_tpu_torch.serving import block_pool, engine

    cls = engine.SlotServer
    fork_child, retire, consume = (cls._fork_child, cls._retire,
                                   cls._consume_chunk)
    copy = engine.copy_pool_block
    seen = {"consumed": 0, "copies": [], "copy_equal": [], "alias": [],
            "bytes_checked": 0, "bytes_changed": [], "snaps": {}}

    def parts(cache):
        return [cache.k, cache.v] + ([cache.k_scale, cache.v_scale]
                                     if hasattr(cache, "k_scale") else [])

    def copied(cache, src, dst, **kw):
        return cache if fault == "skip_copy" else copy(cache, src, dst, **kw)

    def counted(self, slot, n, last):
        seen["consumed"] += n
        return consume(self, slot, n, last)

    def forked(self, parent, child, index, prefix, resv, tick):
        fork_child(self, parent, child, index, prefix, resv, tick)
        B = self.kv_block
        L = len(self._prompt_np[parent]) + max(len(prefix) - 1, 0)
        nshare = L // B
        if L % B:
            src = int(self._host_table[parent, nshare])
            dst = int(self._host_table[child, nshare])
            seen["copies"].append((src, dst))
            seen["copy_equal"].append(all(torch.equal(t[:, dst], t[:, src])
                                          for t in parts(self.cache)))
            if fault == "parent_tail":
                self._host_table[child, nshare] = src
                self._table_dirty = True
            elif fault == "share_tail":
                # The tail shared by refcount and the child's copy unmapped:
                # a consistent ledger, and both branches append into src.
                self._pool.unmap_private(dst)
                self._slot_private[child].discard(dst)
                self._slot_reserve[child] += 1
                self._pool.fork_shared([src])
                self._slot_private[parent].discard(src)
                self._slot_shared[parent].add(src)
                self._slot_shared[child].add(src)
                self._host_table[child, nshare] = src
                self._table_dirty = True
        # The ownership gate: every block two live tables name is shared.
        owners = {}
        for s in range(self.slots):
            if self._slot_req[s] is None:
                continue
            for j in range(self._slot_nblocks[s]):
                owners.setdefault(int(self._host_table[s, j]), []).append(s)
        for bid, slots in owners.items():
            if len(slots) > 1 and self._pool._state[bid] not in (
                    block_pool._SHARED, block_pool._CACHED):
                seen["alias"].append({"block": bid, "slots": slots})
        # The bytes gate's snapshot: the child's shared ancestors.
        uid = self._slot_req[child].uid
        snap = seen["snaps"].setdefault((id(self), uid), {})
        pinned = {n.block_id for n in self._slot_nodes[child]}
        for j in range(self._slot_nblocks[child]):
            bid = int(self._host_table[child, j])
            if (bid in self._slot_shared[child] or bid in pinned) \
                    and bid not in snap:
                snap[bid] = [t[:, bid].clone() for t in parts(self.cache)]

    def retired(self, slot, tick, outcome, results):
        req = self._slot_req[slot]
        key = (id(self), req.uid)
        last = sum(1 for r in self._slot_req
                   if r is not None and r.uid == req.uid) == 1
        if last and key in seen["snaps"]:
            for bid, old in seen["snaps"].pop(key).items():
                seen["bytes_checked"] += 1
                if not all(torch.equal(t[:, bid], o)
                           for t, o in zip(parts(self.cache), old)):
                    seen["bytes_changed"].append(bid)
        return retire(self, slot, tick, outcome, results)

    cls._fork_child, cls._retire, cls._consume_chunk = (forked, retired,
                                                        counted)
    engine.copy_pool_block = copied
    try:
        yield seen
    finally:
        cls._fork_child, cls._retire, cls._consume_chunk = (
            fork_child, retire, consume)
        engine.copy_pool_block = copy


def _read_sse_indexed(port, body, timeout=300):
    """POST ``body`` to the ingress and read its SSE stream: tokens and
    finish reason per ``choices[0].index``, and each index's first-token
    time from the POST."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t_post = time.monotonic()
    conn.request("POST", "/v1/completions", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = {"status": resp.status, "tokens": {}, "finish": {}, "ttft_s": {}}
    while resp.status == 200:
        line = resp.readline()
        if not line:
            break
        line = line.strip()
        if not line.startswith(b"data: "):
            continue
        if line[6:] == b"[DONE]":
            break
        ch = json.loads(line[6:])["choices"][0]
        i = ch["index"]
        if ch["token_ids"] and i not in out["ttft_s"]:
            out["ttft_s"][i] = time.monotonic() - t_post
        out["tokens"].setdefault(i, []).extend(ch["token_ids"])
        if ch["finish_reason"] is not None:
            out["finish"][i] = ch["finish_reason"]
    conn.close()
    return out


def fork_phase(dev, card, serve_args, wrappers, reset_counts, tol_logits,
               faults=FORK_FAULTS) -> dict:
    """Phase 3i: copy-on-write fork families at the serve width, through
    ``SlotServer.serve`` and the ingress (engines from ``cli.build_server``
    on ``serve_args``; the serve phase's prompts, 512 +- 64 tokens, mostly
    not block-aligned, one cut to whole blocks).

    (a) 4 requests with ``n = 2`` against the same 4 prompts as 8
        independent requests, greedy. Gates: each branch's tokens equal
        its independent twins'; every emitted token within ``tol_logits``
        of its position's largest logit (:func:`replay_margin`); the
        prompt tokens computed halve; the peak blocks drop by exactly the
        shared ancestors (``fork_blocks_shared``); one tail copy per
        unaligned prompt, none for the aligned one, each a copy of its
        source's bytes.
    (b) 2 requests with ``n = 2`` under ``--kv-quant int8`` against their
        4 independent twins: tokens equal, the copies carry the scales.
    (c) 2 sampled requests (temperature 1.0, top-k 50, fixed seeds) with
        ``n = 4``: a second serve is bit-identical, branch 0 equals the
        plain ``n = 1`` request of the seed, the branches are not all
        equal.
    (d) ``best_of = 4`` delivers one finish, the branch of highest
        cumulative log-probability, and streams its tokens only;
        ``fork_at = 16`` gives indices 0 and 1 sharing their first 16
        tokens; one ``n = 3`` SSE request through an ``IngressServer`` on
        127.0.0.1 streams three indexed branches equal to the engine's own
        serve of the same seed.
    (e) A cancel before the fork and one mid-family retire every branch; a
        family on a radix hit (``--prefix-cache``) equals the cold family.
    (f) Every serve of the phase runs under :func:`fork_watch`: after
        every serve the pool holds no shared block and the leak report is
        clean; no block outside the shared state is named by two tables
        (the ownership gate); every shared ancestor's bytes are the same
        at fork time and at the family's last retire (the bytes gate).
        Each planted fault of ``faults`` runs a greedy and a sampled
        family of 16 tokens and must fail at least one gate; which ones
        caught it is returned and printed.

    Launch counts are set to 0 just before each serve and read just after.
    ``card`` heads the printed lines. On a CPU the launch counts and copy
    times are not read."""
    with shared_weights():
        return _fork_phase(dev, card, serve_args, wrappers, reset_counts,
                           tol_logits, faults)


def _fork_phase(dev, card, serve_args, wrappers, reset_counts, tol_logits,
                faults) -> dict:
    import numpy as np
    import torch

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.serving import (
        IngressServer,
        Request,
        RequestSource,
        synthetic_trace,
    )
    from tree_attention_tpu_torch.utils.config import parse_args

    class Scripted(RequestSource):
        """A live source: its requests at tick 0, and ``cancels`` ({tick:
        [uid, ...]}) sent through the engine's mailbox at their tick."""

        def __init__(self, eng, requests, cancels):
            self.eng, self._reqs = eng, list(requests)
            self._cancels = dict(cancels)

        def poll(self, tick):
            for t in sorted(k for k in self._cancels if k <= tick):
                for uid in self._cancels.pop(t):
                    self.eng.cancel(uid)
            out, self._reqs = self._reqs, []
            return out

        def next_arrival(self):
            return min(self._cancels) if self._cancels else None

        @property
        def exhausted(self):
            return not self._reqs and not self._cancels

    t_phase = time.monotonic()
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    c = parse_args(serve_args)
    N = c.max_new_tokens
    engines = {}

    def engine(extra=()):
        key = tuple(extra)
        if key not in engines:
            eng = cli.build_server(parse_args(serve_args + list(extra)),
                                   dev)[0]
            # This phase holds the fork-slot path; the token-tree sibling
            # decode of the families that fit its rule is phase 3j's.
            eng._tree_sampling = False
            engines[key] = eng
        return engines[key]

    server = engine()
    blk = server.kv_block
    base = synthetic_trace(4, prompt_len=c.prompt_len,
                           prompt_jitter=c.prompt_jitter, max_new_tokens=N,
                           vocab_size=server.cfg.vocab_size,
                           seed=c.seed + 11)
    prompts = [np.asarray(r.prompt, np.int32) for r in base]
    prompts[3] = prompts[3][:len(prompts[3]) // blk * blk]  # whole blocks
    unaligned = sum(len(p) % blk != 0 for p in prompts)
    sample = dict(temperature=1.0, top_k=50)
    out = {"card": card, "prompt_lens": [len(p) for p in prompts],
           "faults": {}}

    def clean(eng):
        lr = eng.leak_report()
        return leaks_clean(lr) and lr["blocks_shared"] == 0, lr

    def serve(eng, reqs, label, seen):
        """One watched serve: its report, launches and watch deltas."""
        n0, c0 = seen["consumed"], len(seen["copies"])
        reset_counts()
        t0 = time.monotonic()
        rep = eng.serve(reqs)
        sync()
        wall = time.monotonic() - t0
        launches = launch_counts(wrappers)
        ok, lr = clean(eng)
        if not ok:
            fail(f"fork serve ({label}): the engine holds resources after "
                 f"the drain: {lr}")
        return {"rep": rep, "launches": launches, "wall_s": wall,
                "consumed": seen["consumed"] - n0,
                "copies": seen["copies"][c0:],
                "copy_equal": seen["copy_equal"][c0:]}

    def branches(rep):
        return {(r.uid, r.index): list(map(int, r.tokens))
                for r in rep.results}

    def twins(prompt_idx, n_new, uid0=100):
        return [Request(uid=uid0 + 10 * i + j, prompt=prompts[i],
                        max_new_tokens=n_new)
                for i in prompt_idx for j in (0, 1)]

    def family(prompt_idx, n_new, n=2, **kw):
        return [Request(uid=i, prompt=prompts[i], max_new_tokens=n_new,
                        n=n, **kw) for i in prompt_idx]

    def twins_equal(fam, ind, n_new):
        fb, ib = branches(fam), branches(ind)
        return all(fb[(u, b)] == ib[(100 + 10 * u + j, 0)][:n_new]
                   for (u, b) in fb for j in (0, 1))

    def copy_device_ms(eng):
        """One tail copy's device time between two free blocks of
        ``eng``'s pool (the profiler, 20 copies), beside its bound (K and
        V of every layer read once and written once / 3.35 TB/s)."""
        c = eng.cache
        nbytes = 2 * sum(t[:, 0].numel() * t.element_size()
                         for t in (c.k, c.v))
        if not on_card:
            return {"ms": None, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        eng._pool.reserve(2)
        src, dst = eng._pool.alloc(), eng._pool.alloc()
        from tree_attention_tpu_torch.models import copy_pool_block
        copy_pool_block(c, src, dst)
        sync()
        ms, clock = None, "profiler"
        for _ in range(3):  # the profiler now and then traces nothing
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    copy_pool_block(c, src, dst)
                sync()
            dev_us = sum(e.time_range.elapsed_us() for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
            if dev_us:
                ms = dev_us / 20 / 1e3
                break
        if ms is None:
            # CUDA events around 20 copies: host launch gaps included.
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(20):
                copy_pool_block(c, src, dst)
            e1.record()
            e1.synchronize()
            ms, clock = e0.elapsed_time(e1) / 20, "cuda_events"
        eng._pool.free_private(src)
        eng._pool.free_private(dst)
        return {"ms": ms, "clock": clock,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bytes": nbytes}

    def margin(eng, rep, quant):
        reqs = [Request(uid=r.uid, prompt=prompts[r.uid],
                        max_new_tokens=len(r.tokens)) for r in rep.results]
        return replay_margin(eng.params, eng.cfg, rep.results, reqs, quant,
                             "paged", dev, blk)

    with fork_watch() as seen:
        # -- (a) greedy families against independent requests --------------
        # A short serve first: the process's first serve pays one-time
        # costs (allocator, library handles) the timed pair must not.
        serve(server, twins(range(4), 4), "warm-up", seen)
        ind = serve(server, twins(range(4), N), "independent", seen)
        fam = serve(server, family(range(4), N), "family n=2", seen)
        frep, irep = fam["rep"], ind["rep"]
        shared = frep.kv.get("fork_blocks_shared", 0)
        peak_drop = irep.kv["peak_blocks_used"] - frep.kv["peak_blocks_used"]
        fm = margin(server, frep, False)
        sib_ttft = sorted(r.ttft_s for r in frep.results if r.index > 0)
        par_ttft = sorted(r.ttft_s for r in frep.results if r.index == 0)
        a = {
            "outcomes": frep.outcomes,
            "tokens_equal_to_twins": twins_equal(frep, irep, N),
            "replay_margin": fm,
            "prompt_tokens_computed": [fam["consumed"], ind["consumed"]],
            "peak_blocks_used": [frep.kv["peak_blocks_used"],
                                 irep.kv["peak_blocks_used"]],
            "peak_drop": peak_drop, "fork_blocks_shared": shared,
            "forks": frep.kv.get("forks", 0),
            "copies": len(fam["copies"]), "unaligned_prompts": unaligned,
            "copies_equal_source": all(fam["copy_equal"]),
            "launches": {"family": fam["launches"],
                         "independent": ind["launches"]},
            "tokens_per_sec": [frep.tokens_per_sec, irep.tokens_per_sec],
            "ttft_p50_s": {"siblings": sib_ttft[len(sib_ttft) // 2],
                           "parents": par_ttft[len(par_ttft) // 2],
                           "independent": irep.latency_percentiles()[
                               "ttft_p50_s"]},
            "copy_device_ms": copy_device_ms(server),
        }

        out["a"] = a
        print(f"fork family ({card}): 4 requests n=2 vs 8 independent: "
              f"tokens equal {a['tokens_equal_to_twins']}, replay margin "
              f"{fm:.3e} (tol {tol_logits}), prompt tokens computed "
              f"{a['prompt_tokens_computed']}, peak blocks "
              f"{a['peak_blocks_used']} (drop {peak_drop}, shared "
              f"{shared}), tail copies {a['copies']} for {unaligned} "
              f"unaligned prompts (each equal to its source "
              f"{a['copies_equal_source']}), tok/s family "
              f"{frep.tokens_per_sec:.1f} vs independent "
              f"{irep.tokens_per_sec:.1f}, TTFT p50 siblings "
              f"{a['ttft_p50_s']['siblings']:.4f} s, parents "
              f"{a['ttft_p50_s']['parents']:.4f} s, independent "
              f"{a['ttft_p50_s']['independent']:.4f} s (watched serves: the "
              f"gates' snapshots and syncs inside them), one tail copy "
              f"{json.dumps(a['copy_device_ms'])}, "
              f"launches family {json.dumps(fam['launches'])} vs "
              f"independent {json.dumps(ind['launches'])}", flush=True)
        plens = sum(len(p) for p in prompts)
        if not (frep.outcomes == {"budget": 8} and a["tokens_equal_to_twins"]
                and fm <= tol_logits
                and a["prompt_tokens_computed"] == [plens, 2 * plens]
                and peak_drop == shared == sum(len(p) // blk
                                               for p in prompts)
                and a["forks"] == 4 and a["copies"] == unaligned
                and a["copies_equal_source"]):
            fail(f"fork family gates: {a}")
        if on_card and not (fam["launches"]["flash_fwd"] and fam[
                "launches"].get("flash_decode_paged_tick")):
            fail(f"fork family: B3 or B2's tick body never launched: "
                 f"{fam['launches']}")

        # -- (b) the int8 pool ---------------------------------------------
        s8 = engine(["--kv-quant", "int8"])
        ind8 = serve(s8, twins(range(2), N), "int8 independent", seen)
        fam8 = serve(s8, family(range(2), N), "int8 family n=2", seen)
        b = {"tokens_equal_to_twins": twins_equal(fam8["rep"], ind8["rep"],
                                                  N),
             "outcomes": fam8["rep"].outcomes,
             "copies_equal_source": all(fam8["copy_equal"]),
             "copies": len(fam8["copies"]),
             "launches": fam8["launches"]}
        out["b"] = b
        print(f"fork family, int8 ({card}): tokens equal to the int8 twins "
              f"{b['tokens_equal_to_twins']}, copies {b['copies']} (bytes "
              f"and scales equal to their sources {b['copies_equal_source']}"
              f"), launches {json.dumps(fam8['launches'])}", flush=True)
        if not (b["tokens_equal_to_twins"] and b["copies_equal_source"]
                and b["outcomes"] == {"budget": 4}):
            fail(f"int8 fork family gates: {b}")
        if on_card and not fam8["launches"]["flash_decode_paged_q8q"]:
            fail(f"int8 fork family never launched B5: {fam8['launches']}")

        # -- (c) sampled families --------------------------------------------
        seeds = {0: 101, 1: 102}

        def sampled(n_new, n=4):
            return [Request(uid=i, prompt=prompts[i], max_new_tokens=n_new,
                            n=n, seed=seeds[i], **sample) for i in (0, 1)]

        s1 = serve(server, sampled(N), "sampled n=4", seen)
        s2 = serve(server, sampled(N), "sampled n=4 again", seen)
        plain = serve(server, sampled(N, n=1), "sampled n=1", seen)
        b1, b2 = branches(s1["rep"]), branches(s2["rep"])
        pb = branches(plain["rep"])
        cc = {"bit_identical": b1 == b2,
              "branch0_equals_plain": all(b1[(u, 0)] == pb[(u, 0)]
                                          for u in (0, 1)),
              "distinct_branches": [len({tuple(b1[(u, i)])
                                         for i in range(4)})
                                    for u in (0, 1)],
              "tokens_per_sec": s1["rep"].tokens_per_sec}
        out["c"] = cc
        print(f"fork family, sampled ({card}): 2 requests n=4: second serve "
              f"bit-identical {cc['bit_identical']}, branch 0 equal to the "
              f"n=1 stream {cc['branch0_equals_plain']}, distinct branches "
              f"{cc['distinct_branches']}", flush=True)
        if not (cc["bit_identical"] and cc["branch0_equals_plain"]
                and min(cc["distinct_branches"]) >= 2):
            fail(f"sampled fork family gates: {cc}")

        # -- (d) best_of, fork_at, HTTP ---------------------------------------
        got = {"tok": [], "fin": []}
        bo = serve(server, [Request(
            uid=0, prompt=prompts[0], max_new_tokens=N, best_of=4, seed=201,
            on_branch_token=lambda i, t: got["tok"].append((i, t)),
            on_branch_finish=lambda i, r: got["fin"].append((i, r)),
            **sample)], "best_of=4", seen)
        best = max(bo["rep"].results, key=lambda r: (r.cum_logprob, -r.index))
        fa = serve(server, [Request(uid=0, prompt=prompts[1],
                                    max_new_tokens=N, fork_at=16, seed=301,
                                    **sample)], "fork_at=16", seen)
        fab = branches(fa["rep"])
        srv = IngressServer(server, max_queue=4)
        port = srv.start()
        body = {"prompt": [int(t) for t in prompts[2]], "max_tokens": N,
                "n": 3, "seed": 401, **sample}
        reset_counts()
        sse = _read_sse_indexed(port, body)
        srv.drain()
        srv.join(120)
        http_launches = launch_counts(wrappers)
        direct = serve(server, [Request(uid=9, prompt=prompts[2],
                                        max_new_tokens=N, n=3, seed=401,
                                        **sample)], "n=3 direct", seen)
        d = {"best_of_results": len(bo["rep"].results),
             "best_of_finishes": [i for i, _ in got["fin"]],
             "best_of_winner": best.index,
             "best_of_delivered_is_winner": bool(
                 got["fin"]) and got["fin"][0][1].tokens == best.tokens
             and [t for _, t in got["tok"]] == best.tokens
             and all(i == 0 for i, _ in got["tok"]),
             "fork_at_indices": sorted(i for _, i in fab),
             "fork_at_shared_prefix": fab.get((0, 0), [])[:16]
             == fab.get((0, 1), [None])[:16],
             "fork_at_diverge": fab.get((0, 0)) != fab.get((0, 1)),
             "http_status": sse["status"],
             "http_finishes": sse["finish"],
             "http_equal_to_engine": sse["tokens"] == {
                 r.index: list(map(int, r.tokens))
                 for r in direct["rep"].results},
             "http_ttft_s": sse["ttft_s"], "http_launches": http_launches}
        out["d"] = d
        print(f"fork best_of/fork_at/HTTP ({card}): best_of=4 -> "
              f"{d['best_of_results']} branches, finishes delivered "
              f"{d['best_of_finishes']}, the winner (index "
              f"{d['best_of_winner']}) delivered "
              f"{d['best_of_delivered_is_winner']}; fork_at=16 indices "
              f"{d['fork_at_indices']}, first 16 shared "
              f"{d['fork_at_shared_prefix']}, diverge after "
              f"{d['fork_at_diverge']}; HTTP n=3 SSE status "
              f"{d['http_status']}, finishes {d['http_finishes']}, branches "
              f"equal to the engine's serve {d['http_equal_to_engine']}, "
              f"first-token s by index {d['http_ttft_s']}", flush=True)
        if not (d["best_of_results"] == 4 and d["best_of_finishes"] == [0]
                and d["best_of_delivered_is_winner"]
                and d["fork_at_indices"] == [0, 1]
                and d["fork_at_shared_prefix"] and d["http_status"] == 200
                and d["http_finishes"] == {0: "length", 1: "length",
                                           2: "length"}
                and d["http_equal_to_engine"]):
            fail(f"fork best_of/fork_at/HTTP gates: {d}")

        # -- (e) cancels, a radix hit ------------------------------------------
        reset_counts()
        crep = server.serve(Scripted(server, family((0, 1), N),
                                     {1: [1], 8: [0]}))
        sync()
        ok, lr = clean(server)
        e = {"outcomes": crep.outcomes,
             "tokens": {f"{r.uid}/{r.index}": len(r.tokens)
                        for r in crep.results}, "leaks": lr}
        sp = engine(["--prefix-cache", "--prefix-block", str(blk)])
        cold = serve(sp, family((0,), N), "prefix family cold", seen)
        hit = serve(sp, family((0,), N), "prefix family hit", seen)
        hb = branches(hit["rep"])
        e["radix_hit_tokens"] = [r.prefix_hit_tokens
                                 for r in hit["rep"].results]
        e["radix_hit_branches_equal"] = hb[(0, 0)] == hb[(0, 1)]
        e["radix_hit_replay_margin"] = margin(sp, hit["rep"], False)
        # Reported: a hit runs the suffix on other kernels than the cold
        # prefill (B2's multi-row body over the cached blocks against B3),
        # so greedy near-ties may part, as phase 3f found.
        e["radix_hit_tokens_equal_cold"] = sum(
            a == b for k in hb for a, b in zip(hb[k], branches(
                cold["rep"])[k]))
        out["e"] = e
        print(f"fork cancels ({card}): outcomes {e['outcomes']}, tokens by "
              f"branch {e['tokens']}, drained clean {ok}; a family on a "
              f"radix hit of {e['radix_hit_tokens']} tokens: branches equal "
              f"{e['radix_hit_branches_equal']}, replay margin "
              f"{e['radix_hit_replay_margin']:.3e} (tol {tol_logits}), "
              f"{e['radix_hit_tokens_equal_cold']} of {2 * N} tokens equal "
              f"to the cold family's (reported)", flush=True)
        if not (ok and e["outcomes"] == {"cancelled": 4}
                and e["tokens"]["1/0"] == e["tokens"]["1/1"] == 0
                and 0 < e["tokens"]["0/0"] < N
                and 0 < e["tokens"]["0/1"] < N
                and e["radix_hit_branches_equal"]
                and e["radix_hit_replay_margin"] <= tol_logits
                and min(e["radix_hit_tokens"]) > 0
                and clean(sp)[0]):
            fail(f"fork cancel/radix gates: {e}")

    # The timings: the watch's snapshots and checks run inside the watched
    # serves, so the pair of (a) is served again unwatched, in turns.
    timed = {"family": [], "independent": []}
    for label in ("family", "independent", "family", "independent"):
        t_rep = server.serve(family(range(4), N) if label == "family"
                             else twins(range(4), N))
        sync()
        sib = sorted(r.ttft_s for r in t_rep.results if r.index > 0)
        par = sorted(r.ttft_s for r in t_rep.results if r.index == 0)
        timed[label].append({
            "tokens_per_sec": t_rep.tokens_per_sec,
            "ttft_p50_s": par[len(par) // 2],
            "sibling_ttft_p50_s": sib[len(sib) // 2] if sib else None,
            "wall_s": t_rep.wall_s})
    out["a"]["timed_unwatched"] = timed
    print(f"fork family ({card}), unwatched serves in turns (family, "
          f"independent, family, independent): " + json.dumps(
              {k: [{m: round(x, 5) if x is not None else None
                    for m, x in r.items()} for r in v]
               for k, v in timed.items()}), flush=True)

    # -- (f) the bytes and ownership gates, and their teeth -------------------
    out["f"] = {"alias": seen["alias"], "bytes_checked": seen["bytes_checked"],
                "bytes_changed": seen["bytes_changed"]}
    print(f"fork gates ({card}): shared ancestor blocks checked at the "
          f"family's last retire {seen['bytes_checked']}, changed "
          f"{len(seen['bytes_changed'])}; blocks named by two tables "
          f"outside the shared state {len(seen['alias'])}", flush=True)
    if seen["alias"] or seen["bytes_changed"] or not seen["bytes_checked"]:
        fail(f"fork bytes/ownership gates: {out['f']}")
    short = 16
    ref_greedy = branches(ind["rep"])
    ref_plain = pb
    for fault in faults:
        with fork_watch(fault) as fseen:
            g = serve(server, family((0, 1), short), f"fault {fault}",
                      fseen)
            s = serve(server, sampled(short, n=2), f"fault {fault} sampled",
                      fseen)
        gb, sb = branches(g["rep"]), branches(s["rep"])
        caught = {
            "tokens": not all(gb[(u, i)] == ref_greedy[(100 + 10 * u, 0)][
                :short] for u in (0, 1) for i in (0, 1)),
            "replay": margin(server, g["rep"], False) > tol_logits,
            "sampled_branch0": not all(sb[(u, 0)] == ref_plain[(u, 0)][
                :short] for u in (0, 1)),
            "copy": not all(g["copy_equal"] + s["copy_equal"]),
            "ownership": bool(fseen["alias"]),
            "bytes": bool(fseen["bytes_changed"]),
        }
        out["faults"][fault] = caught
        print(f"fork planted fault {fault!r} ({card}): gates that rejected "
              f"it {[k for k, v in caught.items() if v]}", flush=True)
        if not any(caught.values()):
            fail(f"fork phase: every gate passed the planted fault {fault!r}")
    out["wall_s"] = time.monotonic() - t_phase
    print(f"fork phase wall ({card}) {out['wall_s']:.2f}s", flush=True)
    return out


TREE_FAULTS = ("sibling_mask", "skip_collapse_compaction")
TREE_SHORT_PROMPT = 16  # the fault-sensitive families' prompt length


@contextlib.contextmanager
def tree_watch(fault=None):
    """Watch token-tree sibling families from outside the engine: for each
    serve, the most slots one request held at once, and the tree ticks'
    bundle rows. ``fault`` plants one of :data:`TREE_FAULTS`: a mask bit
    letting every branch see its siblings' rows (the whole bundle lower
    triangular), or a collapse that leaves a survivor at rank > 0 where
    its rows were written."""
    import numpy as np

    from tree_attention_tpu_torch.serving import engine
    from tree_attention_tpu_torch.serving.speculation import PackedSpec

    cls = engine.SlotServer
    step, pack, compact, fwd = cls._step, engine.pack_siblings, \
        engine.compact_decode_window, engine.forward_step
    seen = {"max_slots_per_uid": 0, "bundle_rows": [], "capture": False,
            "rows": [], "tree_tq": {}}

    def forwarded(*args, **kwargs):
        logits, cache = fwd(*args, **kwargs)
        seen["logits"] = logits
        return logits, cache

    def stepped(self, tokens, n_vec, reset, reset_val, emit, verify=None):
        per_uid = {}
        for rq in self._slot_req:
            if rq is not None:
                per_uid[rq.uid] = per_uid.get(rq.uid, 0) + 1
        seen["max_slots_per_uid"] = max([seen["max_slots_per_uid"],
                                         *per_uid.values()])
        # The rows that draw this step's tokens: each tree branch's last
        # bundle row, each plain live slot's one row; ``(uid, index, j)``:
        # the row predicts the branch's token ``j``.
        want = []
        if any(self._slot_state[i] == "live" and f.forked
               for i, f in self._tree_fams.items()):
            tq = int(tokens.shape[1])
            seen["tree_tq"][tq] = seen["tree_tq"].get(tq, 0) + 1
        for i, fam in self._tree_fams.items():
            if self._slot_state[i] == "live" and fam.forked:
                seen["bundle_rows"].append(int(n_vec[i]))
                _, order, s = self._pack_tree(fam)
                want += [(i, r * s + s - 1, fam.req.uid, fam.br_index[b],
                          len(fam.br_tokens[b]))
                         for r, b in enumerate(order)]
        for i, st in enumerate(self._slot_state):
            if st == "live" and i not in self._tree_fams and emit[i]:
                want.append((i, 0, self._slot_req[i].uid,
                             self._slot_index[i], len(self._slot_tokens[i])))
        out = step(self, tokens, n_vec, reset, reset_val, emit, verify)
        if seen["capture"]:
            lg = seen["logits"]
            seen["rows"] += [(uid, idx, j, lg[i, r].float().clone())
                             for i, r, uid, idx, j in want]
        return out

    def packed(suffixes):
        p = pack(suffixes)
        if fault == "sibling_mask":
            p = PackedSpec(row_tokens=p.row_tokens,
                           row_parents=p.row_parents, depth=p.depth,
                           anc=np.tril(np.ones_like(p.anc)))
        return p

    def compacted(cache, *args):
        return cache if fault == "skip_collapse_compaction" else \
            compact(cache, *args)

    cls._step = stepped
    engine.pack_siblings = packed
    engine.compact_decode_window = compacted
    engine.forward_step = forwarded
    try:
        yield seen
    finally:
        cls._step = step
        engine.pack_siblings = pack
        engine.compact_decode_window = compact
        engine.forward_step = fwd


def tree_phase(dev, card, serve_args, wrappers, reset_counts, tol_logits,
               faults=TREE_FAULTS) -> dict:
    """Phase 3j: token-tree sibling families at the serve width, through
    ``SlotServer.serve`` (engines from ``cli.build_server`` on
    ``serve_args``; the serve phase's prompts, 512 +- 64 tokens, and short
    ones of :data:`TREE_SHORT_PROMPT` tokens). Every family fits the tree
    rule (``k * (max_new - 1) <= 32``): ``n = 4`` with 8 new tokens (28
    bundle rows) and ``n = 8`` with 4 (24 rows).

    (a) Greedy, exact then ``--kv-quant int8``: the families on the tree
        engine against the same families on the fork-slot path
        (``tree_sampling`` off). Gates: each family held ONE slot (the
        fork-slot path one per branch); every emitted token within
        ``tol_logits`` of its position's largest logit (the replay gate,
        :func:`replay_margin`); the tokens equal to the fork-slot family's
        (where two branches part on a bf16 near-tie, the replay gate
        holds them and the count is printed); the ``tree`` variant of B2
        (exact) or B5 (int8) launched exactly once per layer per tree tick
        and the plain ticks on the tick body; the pool drained.
    (b) ``n = 8`` on a one-slot engine serves all eight branches.
    (c) Sampled (temperature 1.0, top-k 50, fixed seeds) on short prompts,
        exact then int8: every logits row that drew a branch's token (each
        branch's last bundle row of every tree tick, each plain row after a
        collapse) against the row of the teacher-forced replay of that
        branch's tokens on the plain decode path (the logit gate: within
        ``tol_logits``), a second serve bit-identical, the branches not all
        equal; the tokens equal to the fork-slot family's under the same
        seeds (printed). An ``n = 2`` family whose branch 0 stops on an EOS
        only it drew: the survivor at rank 1 is compacted to the front of
        the window and decodes on to its budget, under the same gate.
    (d) Each planted fault of ``faults`` reruns (c)'s exact families (the
        faults sit in the host's packing and collapse, which both
        precisions share) and must fail the logit gate.

    Launch counts are set to 0 just before each serve and read just after.
    On a CPU the launch counts are not read."""
    with shared_weights():
        return _tree_phase(dev, card, serve_args, wrappers, reset_counts,
                           tol_logits, faults)


def _tree_phase(dev, card, serve_args, wrappers, reset_counts, tol_logits,
                faults) -> dict:
    import numpy as np
    import torch

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.serving import Request, synthetic_trace
    from tree_attention_tpu_torch.utils.config import parse_args

    t_phase = time.monotonic()
    on_card = dev.type == "cuda"
    c = parse_args(serve_args)
    engines = {}

    def engine(extra=(), tree=True):
        key = (tuple(extra), tree)
        if key not in engines:
            eng = cli.build_server(parse_args(serve_args + list(extra)),
                                   dev)[0]
            eng._tree_sampling = tree
            engines[key] = eng
        return engines[key]

    server = engine()
    blk = server.kv_block
    n_layers = server.cfg.n_layers
    base = synthetic_trace(2, prompt_len=c.prompt_len,
                           prompt_jitter=c.prompt_jitter, max_new_tokens=8,
                           vocab_size=server.cfg.vocab_size,
                           seed=c.seed + 21)
    prompts = {0: np.asarray(base[0].prompt, np.int32),
               1: np.asarray(base[1].prompt, np.int32)}
    rng = np.random.default_rng(c.seed + 22)
    for u in (2, 3):
        prompts[u] = rng.integers(0, server.cfg.vocab_size,
                                  TREE_SHORT_PROMPT).astype(np.int32)
    shapes = {0: (4, 8), 1: (8, 4), 2: (4, 8), 3: (8, 4)}  # uid: (n, new)
    sample = dict(temperature=1.0, top_k=50)
    out = {"card": card, "prompt_lens": {u: len(p)
                                         for u, p in prompts.items()},
           "faults": {}, "n_layers": n_layers}

    def families(uids, eos=None, seeds=None, **kw):
        return [Request(uid=u, prompt=prompts[u],
                        max_new_tokens=shapes[u][1], n=shapes[u][0],
                        eos_id=eos, seed=None if seeds is None else seeds[u],
                        **kw) for u in uids]

    def branches(rep):
        return {(r.uid, r.index): list(map(int, r.tokens))
                for r in rep.results}

    def serve(eng, reqs, label, seen):
        reset_counts()
        m0 = seen["max_slots_per_uid"]
        seen["max_slots_per_uid"] = 0
        seen["tree_tq"] = {}
        t0 = time.monotonic()
        rep = eng.serve(reqs)
        if on_card:
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = launch_counts(wrappers)
        tiled_tq = {n: dict(sorted(w.tiled_tq.items()))
                    for n, w in wrappers.items()
                    if getattr(w, "tiled_tq", None)}
        tree_tq = {n: dict(sorted(w.tree_tq.items()))
                   for n, w in wrappers.items()
                   if getattr(w, "tree_tq", None)}
        slots = seen["max_slots_per_uid"]
        seen["max_slots_per_uid"] = max(m0, slots)
        lr = eng.leak_report()
        if not (leaks_clean(lr) and lr["blocks_shared"] == 0
                and not eng._tree_fams and not eng._families):
            fail(f"tree serve ({label}): the engine holds resources after "
                 f"the drain: {lr}")
        return {"rep": rep, "launches": launches, "tiled_tq": tiled_tq,
                "tree_tq": tree_tq, "wall_s": wall, "max_slots_per_uid": slots,
                "tree_ticks_by_tq": dict(sorted(seen["tree_tq"].items()))}

    def logit_gap(eng, rep, quant, rows):
        """The largest |logit| gap between the rows that drew a serve's
        tokens (``rows``: ``(uid, index, j, row)``) and the teacher-forced
        replay of each branch's tokens on the plain decode path."""
        replay = []
        replay_margin(eng.params, eng.cfg, rep.results,
                      [Request(uid=r.uid, prompt=prompts[r.uid],
                               max_new_tokens=1) for r in rep.results],
                      quant, "paged", dev, blk, rows_out=replay)
        by = {(r.uid, r.index): x for r, x in zip(rep.results, replay)}
        gap = 0.0
        for uid, idx, j, row in rows:
            gap = max(gap, (row - by[(uid, idx)][j]).abs().max().item())
        return gap

    def captured(eng, reqs, label, seen):
        seen["capture"], seen["rows"] = True, []
        try:
            r = serve(eng, reqs, label, seen)
        finally:
            seen["capture"] = False
        r["rows"] = seen["rows"]
        return r

    def greedy_margin(eng, rep, quant):
        return replay_margin(eng.params, eng.cfg, rep.results,
                             [Request(uid=r.uid, prompt=prompts[r.uid],
                                      max_new_tokens=1)
                              for r in rep.results], quant, "paged", dev,
                             blk)

    seeds = {0: 501, 1: 502, 2: 503, 3: 504}

    def sampled_check(eng, fork, quant, label, seen, eos_case):
        """(c) on ``eng``: the logit gate, determinism, diversity
        and the fork-slot comparison; then the EOS/collapse family."""
        s1 = captured(eng, families((2, 3), seeds=seeds, **sample),
                      f"{label} sampled", seen)
        s2 = serve(eng, families((2, 3), seeds=seeds, **sample),
                   f"{label} sampled again", seen)
        f1 = serve(fork, families((2, 3), seeds=seeds, **sample),
                   f"{label} sampled fork-slot", seen)
        b1, bf = branches(s1["rep"]), branches(f1["rep"])
        r = {"logit_gap": logit_gap(eng, s1["rep"], quant, s1["rows"]),
             "rows_checked": len(s1["rows"]),
             "bit_identical": b1 == branches(s2["rep"]),
             "distinct_branches": [len({tuple(b1[(u, i)])
                                        for i in range(shapes[u][0])})
                                   for u in (2, 3)],
             "tokens_equal_fork_slot": sum(
                 a == b for k in b1 for a, b in zip(b1[k], bf[k])),
             # Drawn from the same prompt-end logits (one prefill step of
             # the same shape on both engines) under the same keys.
             "first_tokens_equal_fork_slot": sorted(b1) == sorted(bf)
             and all(b1[k][:1] == bf[k][:1] for k in b1),
             "tokens": sum(len(t) for t in b1.values()),
             "tree_families": s1["rep"].kv.get("tree_families", 0),
             "max_slots_per_uid": s1["max_slots_per_uid"]}
        # The survivor at rank 1: branch 0 of an n = 2 family on prompt 2
        # stops on a token only it drew (not its first; the latest such of
        # its first six, so the survivor's suffix is long when it is
        # compacted), branch 1 runs on.
        def pair(eos=None):
            return [Request(uid=2, prompt=prompts[2], max_new_tokens=8, n=2,
                            eos_id=eos, seed=seeds[2], **sample)]

        if "eos" not in eos_case:
            p0 = branches(serve(eng, pair(), f"{label} n=2", seen)["rep"])
            b0, b1_ = p0[(2, 0)], p0[(2, 1)]
            eos_case["eos"] = next(
                (b0[j] for j in range(5, 0, -1)
                 if b0[j] not in b0[:j] and b0[j] not in b1_), None)
        eos = eos_case["eos"]
        if eos is not None:
            e = captured(eng, pair(eos), f"{label} eos", seen)
            ef = serve(fork, pair(eos), f"{label} eos fork-slot", seen)
            got = {rr.index: rr for rr in e["rep"].results}
            eb, efb = branches(e["rep"]), branches(ef["rep"])
            r["eos"] = {
                "eos_token": int(eos),
                "branch0": [got[0].outcome, len(got[0].tokens)],
                "survivor": [got[1].outcome, len(got[1].tokens)],
                "tree_ticks": e["rep"].kv.get("tree_ticks", 0),
                "logit_gap": logit_gap(eng, e["rep"], quant, e["rows"]),
                "rows_checked": len(e["rows"]),
                "tokens_equal_fork_slot": sum(
                    a == b for k in eb for a, b in zip(eb[k], efb[k])),
                "first_tokens_equal_fork_slot": sorted(eb) == sorted(efb)
                and all(eb[k][:1] == efb[k][:1] for k in eb),
                "tokens": sum(len(t) for t in eb.values())}
        return r

    with tree_watch() as seen:
        # -- (a) greedy families, exact then int8 ---------------------------
        serve(server, families((0,)), "warm-up", seen)
        for quant in (False, True):
            extra = ["--kv-quant", "int8"] if quant else []
            eng, fork = engine(extra), engine(extra, tree=False)
            label = "int8" if quant else "exact"
            t = serve(eng, families((0, 1)), f"{label} tree", seen)
            f = serve(fork, families((0, 1)), f"{label} fork-slot", seen)
            tb, fb = branches(t["rep"]), branches(f["rep"])
            kv = t["rep"].kv
            tree_kernel = ("flash_decode_paged_q8q" if quant
                           else "flash_decode_paged")
            a = {"tokens_equal_fork_slot": sum(
                     x == y for k in tb for x, y in zip(tb[k], fb[k])),
                 "tokens": sum(len(v) for v in tb.values()),
                 "replay_margin": greedy_margin(eng, t["rep"], quant),
                 "tree_families": kv.get("tree_families", 0),
                 "tree_ticks": kv.get("tree_ticks", 0),
                 "tree_launches": t["launches"].get(tree_kernel + "_tree",
                                                    0),
                 "tiled_tq": t["tiled_tq"].get(tree_kernel, {}),
                 "tree_launches_by_tq": t["tree_tq"].get(tree_kernel, {}),
                 "tree_ticks_by_tq": t["tree_ticks_by_tq"],
                 "max_slots_per_uid": t["max_slots_per_uid"],
                 "fork_slot_max_slots_per_uid": f["max_slots_per_uid"],
                 "bundle_rows_max": max(seen["bundle_rows"] or [0]),
                 "launches": t["launches"],
                 "fork_slot_launches": f["launches"],
                 "wall_s": [t["wall_s"], f["wall_s"]],
                 "tokens_per_sec": [t["rep"].tokens_per_sec,
                                    f["rep"].tokens_per_sec],
                 "peak_blocks_used": [kv["peak_blocks_used"],
                                      f["rep"].kv["peak_blocks_used"]]}
            out[f"a_{label}"] = a
            print(f"tree families, greedy {label} ({card}): n=4 x 8 and n=8 "
                  f"x 4 on {[len(prompts[u]) for u in (0, 1)]}-token "
                  f"prompts: tree families {a['tree_families']}, one slot "
                  f"each (max slots a request held {a['max_slots_per_uid']}"
                  f", fork-slot path {a['fork_slot_max_slots_per_uid']}), "
                  f"tree ticks {a['tree_ticks']} (by Tq "
                  f"{a['tree_ticks_by_tq']}), {tree_kernel} tree launches "
                  f"{a['tree_launches']} (by Tq, counted where they launch "
                  f"{a['tree_launches_by_tq']}), multi-row launches by Tq "
                  f"{a['tiled_tq']} (prompt chunks ride 32-row chunks "
                  f"while a tree family is admitted), "
                  f"tokens equal to the fork-slot family "
                  f"{a['tokens_equal_fork_slot']} of {a['tokens']}, replay "
                  f"margin {a['replay_margin']:.3e} (tol {tol_logits}), "
                  f"peak blocks tree/fork-slot {a['peak_blocks_used']}, "
                  f"tok/s {[round(x, 1) for x in a['tokens_per_sec']]}, "
                  f"launches {json.dumps(a['launches'])}", flush=True)
            if not (a["tree_families"] == 2 and a["max_slots_per_uid"] == 1
                    and a["fork_slot_max_slots_per_uid"] == 8
                    and a["replay_margin"] <= tol_logits
                    and t["rep"].outcomes == {"budget": 12}):
                fail(f"tree family gates ({label}): {a}")
            if on_card and not (
                    a["tree_launches"] == n_layers * a["tree_ticks"] > 0
                    and sum(a["tree_ticks_by_tq"].values())
                    == a["tree_ticks"]
                    and sum(a["tree_launches_by_tq"].values())
                    == a["tree_launches"]
                    and a["tree_launches_by_tq"] == {
                        tq: n * n_layers
                        for tq, n in a["tree_ticks_by_tq"].items()}
                    and all(a["tiled_tq"].get(tq, 0) >= n for tq, n in
                            a["tree_launches_by_tq"].items())):
                fail(f"tree family launches ({label}): {tree_kernel}'s "
                     f"tree variant must run once per layer per tree tick "
                     f"at the tick's Tq, on the multi-row body: {a}")

        # -- (b) n = 8 on one slot --------------------------------------------
        one = engine(["--slots", "1"])
        o = serve(one, families((1,)), "n=8 on one slot", seen)
        out["b"] = {"branches": sorted(i for _, i in branches(o["rep"])),
                    "tree_families": o["rep"].kv.get("tree_families", 0),
                    "launches": o["launches"]}
        print(f"tree family n=8 on a one-slot engine ({card}): branches "
              f"{out['b']['branches']}, launches "
              f"{json.dumps(o['launches'])}", flush=True)
        if out["b"]["branches"] != list(range(8)) \
                or out["b"]["tree_families"] != 1:
            fail(f"n=8 on one slot: {out['b']}")

        # -- (c) sampled families on short prompts ----------------------------
        eos_cases = {False: {}, True: {}}
        for quant in (False, True):
            extra = ["--kv-quant", "int8"] if quant else []
            label = "int8" if quant else "exact"
            cc = sampled_check(engine(extra), engine(extra, tree=False),
                               quant, label, seen, eos_cases[quant])
            out[f"c_{label}"] = cc
            print(f"tree families, sampled {label} ({card}): logit gap to "
                  f"the replay {cc['logit_gap']:.3e} over "
                  f"{cc['rows_checked']} rows (tol {tol_logits}), "
                  f"second serve bit-identical {cc['bit_identical']}, "
                  f"distinct branches {cc['distinct_branches']}, tokens "
                  f"equal to the fork-slot families "
                  f"{cc['tokens_equal_fork_slot']} of {cc['tokens']} (every "
                  f"branch's first token equal "
                  f"{cc['first_tokens_equal_fork_slot']}); "
                  f"EOS/collapse {json.dumps(cc.get('eos'))}", flush=True)
            ok = (cc["logit_gap"] <= tol_logits and cc["bit_identical"]
                  and cc["first_tokens_equal_fork_slot"]
                  and min(cc["distinct_branches"]) >= 2
                  and cc["tree_families"] == 2
                  and cc["max_slots_per_uid"] == 1)
            e = cc.get("eos")
            if e is None or not (e["branch0"][0] == "eos"
                                 and e["survivor"] == ["budget", 8]
                                 and e["first_tokens_equal_fork_slot"]
                                 and e["logit_gap"] <= tol_logits):
                ok = False
            if not ok:
                fail(f"sampled tree family gates ({label}): {cc}")
    out["wall_s_clean"] = time.monotonic() - t_phase

    # -- (d) the gates' teeth -------------------------------------------------
    for fault in faults:
        with tree_watch(fault) as fseen:
            ref = out["c_exact"]
            cc = sampled_check(engine(), engine(tree=False), False,
                               f"fault {fault} exact", fseen,
                               eos_cases[False])
            e = cc.get("eos") or {}
            caught = {"exact": {
                "gaps": [cc["logit_gap"], e.get("logit_gap", 0.0)],
                "logit_gap": cc["logit_gap"] > tol_logits
                or e.get("logit_gap", 0.0) > tol_logits,
                "fork_slot_tokens":
                    cc["tokens_equal_fork_slot"]
                    < ref["tokens_equal_fork_slot"]
                    or e.get("tokens_equal_fork_slot", 0)
                    < ref["eos"]["tokens_equal_fork_slot"]}}
        out["faults"][fault] = caught
        print(f"tree planted fault {fault!r} ({card}): gates that rejected "
              f"it {caught} (logit gaps: the families', the EOS pair's)",
              flush=True)
        if not all(v["logit_gap"] for v in caught.values()):
            fail(f"tree phase: the logit gate passed the planted fault "
                 f"{fault!r}: {caught}")
    out["wall_s"] = time.monotonic() - t_phase
    print(f"tree phase wall ({card}) {out['wall_s']:.2f}s", flush=True)
    return out


DISAGG_ARGS = ["--serve-disagg", "--prefill-slots", "2"]
DISAGG_FAULTS = ("copy_into_second_pool", "re_reserve")


@contextlib.contextmanager
def disagg_watch(fault=None):
    """Watch the handoffs of :class:`DisaggServer` from outside: per
    adoption, the private blocks the prefill slot held, the blocks the
    allocator counted transferred, whether the decode slot's table row
    names the same block ids, the allocator's availability, reservations
    and generation before and after (a handoff moves none of them), and on
    the card the device kernels and copies the adoption issued (traced:
    none, so no KV byte moves); every decode-worker step's Tq.

    ``fault`` plants one of :data:`DISAGG_FAULTS`: a decode worker with a
    pool of its own into which each handoff copies the blocks, or an
    adoption that returns the prefill side's reservation and reserves it
    again instead of transferring the blocks."""
    import torch

    from tree_attention_tpu_torch.serving import disagg

    cls = disagg.DisaggServer
    adopt, relay, init = cls._adopt, cls._relay_pool, cls.__init__
    seen = {"handoffs": [], "decode_tq": [], "traced_handoffs": 0}

    def adopted(self, p, d, tick):
        pf, dc, pool = self.prefill, self.decode, self.pool
        bids = sorted(pf._slot_private[p])
        nb = pf._slot_nblocks[p]
        row = [int(x) for x in pf._host_table[p, :nb]]
        before = (pool.available(), pool.reserved, pool.gen)
        t0 = pool.transferred
        on_card = pf.device.type == "cuda"
        trace = on_card and seen["traced_handoffs"] < 8
        if trace:
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        if fault == "re_reserve":
            resv = pf._slot_reserve[p]
            pool.unreserve(resv)
            pool.reserve(resv)
            tp = pool.transfer_private
            pool.transfer_private = lambda b: 0
            try:
                adopt(self, p, d, tick)
            finally:
                pool.transfer_private = tp
        else:
            adopt(self, p, d, tick)
        if fault == "copy_into_second_pool":
            for name in self._pool_fields:
                src, dst = getattr(pf.cache, name), getattr(dc.cache, name)
                dst[:, row] = src[:, row]
        device_ops = None
        if trace:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            device_ops = sum(1 for e in prof.events() if e.device_type
                             == torch.autograd.DeviceType.CUDA)
            seen["traced_handoffs"] += 1
        seen["handoffs"].append({
            "private": len(bids), "transferred": pool.transferred - t0,
            "same_ids": [int(x) for x in dc._host_table[d, :nb]] == row,
            "ledger_unchanged": before == (pool.available(), pool.reserved,
                                           pool.gen),
            "device_ops": device_ops})

    def relayed(self, src, dst):
        if fault != "copy_into_second_pool":
            relay(self, src, dst)

    def built(self, *a, **kw):
        init(self, *a, **kw)
        if fault == "copy_into_second_pool":
            # The decode worker keeps a pool of its own.
            for name in self._pool_fields:
                setattr(self.decode.cache, name,
                        getattr(self.prefill.cache, name).clone())
        step = self.decode._step

        def decode_step(tokens, *args, **kwargs):
            seen["decode_tq"].append(int(tokens.shape[1]))
            return step(tokens, *args, **kwargs)

        self.decode._step = decode_step

    cls._adopt, cls._relay_pool, cls.__init__ = adopted, relayed, built
    try:
        yield seen
    finally:
        cls._adopt, cls._relay_pool, cls.__init__ = adopt, relay, init


def disagg_phase(dev, card, serve_args, wrappers, reset_counts, tol_logits,
                 faults=DISAGG_FAULTS) -> dict:
    """Phase 3k: disaggregated prefill/decode serving at the serve width:
    the serve phase's 16-request trace (512 +- 64-token prompts, 64 new
    tokens) through ``--serve-disagg --prefill-slots 2`` (6 decode slots
    over one pool), exact then ``--kv-quant int8``, against the fused
    engine's serve of the same trace.

    Gates: the tokens equal the fused serve's, or where a stream parts on
    a bf16 near-tie every emitted token is within ``tol_logits`` of its
    position's largest logit (the replay gate); both workers' caches on
    the same pool storage (``data_ptr``, and int8's block scales) before
    and after; every handoff: the decode slot's table row names the prefill
    slot's block ids, the allocator counted exactly its private blocks
    transferred, its availability, reservations and generation unchanged,
    and (on the card, the first 8 handoffs traced) no device kernel or copy
    issued — no KV byte moved; every decode-worker step at Tq 1; B3 for the
    prefill chunks and the decode ticks on the tick body (B2, or B5 under
    int8) counted; the leak report drained with ``blocks_transferred`` equal
    to the handed-off private blocks. Each planted fault of ``faults`` must
    fail a gate. The exact pair serve runs with the request ledger armed:
    every request's ledger charges its handoff segment and reconciles, and
    the report's aggregates are its ledgers'; a ledger that drops ``park``
    (4 requests) must fail those gates. Launch counts are set to 0 just
    before each serve and read just after; on a CPU they are not read."""
    with shared_weights():
        return _disagg_phase(dev, card, serve_args, wrappers, reset_counts,
                             tol_logits, faults)


def _disagg_phase(dev, card, serve_args, wrappers, reset_counts, tol_logits,
                  faults) -> dict:
    import torch

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch import obs
    from tree_attention_tpu_torch.serving import synthetic_trace
    from tree_attention_tpu_torch.utils.config import parse_args

    t_phase = time.monotonic()
    on_card = dev.type == "cuda"
    c = parse_args(serve_args)
    out = {"card": card, "faults": {}}

    def trace(vocab):
        return synthetic_trace(
            c.requests, prompt_len=c.prompt_len,
            prompt_jitter=c.prompt_jitter, max_new_tokens=c.max_new_tokens,
            arrival_every=c.arrival_every, vocab_size=vocab,
            seed=c.seed + 1, prefix_share=c.prefix_share,
            prefix_len=c.prefix_len)

    def tokens(rep):
        return {r.uid: list(map(int, r.tokens)) for r in rep.results}

    def run(extra, seen, label, requests=None, ledger=False):
        srv = cli.build_server(parse_args(serve_args + DISAGG_ARGS + extra),
                               dev)[0]
        shared0 = srv.pool_shared()
        n0 = len(seen["handoffs"])
        seen["decode_tq"].clear()
        tr = trace(srv.cfg.vocab_size)[:requests]
        # The flight ring and the request ledger, on one pair serve (the
        # ledger also on the planted fault's).
        armed = label == "exact"
        if armed:
            obs.FLIGHT.clear()
            obs.FLIGHT.arm(capacity=FLIGHT_CAPACITY)
        if armed or ledger:
            obs.REQLOG.arm()
        reset_counts()
        t0 = time.monotonic()
        try:
            rep = srv.serve(tr)
        finally:
            obs.FLIGHT.disarm()
            obs.REQLOG.disarm()
        if on_card:
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = launch_counts(wrappers)
        hs = seen["handoffs"][n0:]
        lr = srv.leak_report()
        r = {"srv": srv, "rep": rep, "trace": tr, "launches": launches,
             "wall_s": wall, "pool_shared": [shared0, srv.pool_shared()],
             "handoff": rep.handoff, "leaks": lr,
             "handed_private": sum(h["private"] for h in hs),
             "transferred_each": all(h["transferred"] == h["private"]
                                     for h in hs),
             "same_ids": all(h["same_ids"] for h in hs),
             "ledger_unchanged": all(h["ledger_unchanged"] for h in hs),
             "device_ops": [h["device_ops"] for h in hs
                            if h["device_ops"] is not None],
             "decode_tq": sorted(set(seen["decode_tq"])),
             "drained": leaks_clean(lr) and srv.all_slots_free}
        if armed:
            r["flight"] = obs.FLIGHT.snapshot()
            obs.FLIGHT.clear()
        return r

    def pair_flight_gates(r):
        """The armed pair serve's records: every record worker-tagged,
        each executed tick one prefill and one decode record in order, the
        decode records' tokens the report's but each request's first
        (the prefill worker samples it, as in the JAX pair)."""
        rep, snap = r["rep"], r["flight"]
        recs = snap["records"]
        dec = [x for x in recs if x.get("worker") == "decode"]
        pre = [x for x in recs if x.get("worker") == "prefill"
               and not x.get("sweep_only")]
        firsts = sum(1 for x in rep.results if x.tokens)
        emitted = sum(x["tokens_emitted"] for x in dec)
        r["flight_summary"] = {
            "records": len(recs), "decode": len(dec), "prefill": len(pre),
            "decode_tokens_emitted": emitted, "first_tokens": firsts,
            "report_tokens": rep.tokens_generated}
        return {
            "workers": {x.get("worker") for x in recs}
            == {"prefill", "decode"},
            "ring_holds_run": snap["ticks_recorded"] == len(recs),
            "ticks": [x["tick"] for x in dec] == [x["tick"] for x in pre]
            == list(range(rep.ticks)),
            "decode_tokens_plus_firsts_equal_report":
            emitted + firsts == rep.tokens_generated,
            "last_kv_blocks_used_equal_pool":
            bool(dec) and dec[-1]["kv_blocks_used"] == r["srv"].pool.used,
        }

    def pair_ledger_gates(r):
        """The armed pair serve's ledgers: one a request, each charging
        its handoff segment, reconciled (:func:`ledger_gates`), and the
        report's aggregates theirs."""
        rep = r["rep"]
        lgs = [x.ledger for x in rep.results]
        ok = all(lg is not None for lg in lgs)
        r["ledger_summary"] = {"handoff_s": [lg["handoff_s"] for lg in lgs]
                               if ok else None, "requests": rep.requests}
        return {
            "one_per_request": ok,
            "handoff_charged": ok and all(lg["handoff_s"] > 0 for lg in lgs),
            **(ledger_gates(lgs, [len(x.tokens) for x in rep.results])
               if ok else {}),
            "report_equal_aggregate": ok
            and rep.requests == obs.aggregate_ledgers(lgs)}

    def gates(r, fused, quant):
        rep = r["rep"]
        t = tokens(rep)
        fz = {u: v for u, v in tokens(fused["rep"]).items() if u in t}
        r["tokens_equal_fused"] = sum(a == b for k in t
                                      for a, b in zip(t[k], fz[k]))
        r["tokens"] = sum(len(v) for v in t.values())
        r["replay_margin"] = 0.0 if t == fz else replay_margin(
            r["srv"].params, r["srv"].cfg, rep.results, r["trace"], quant,
            "paged", dev, r["srv"].kv_block)
        return {
            "tokens": t == fz or r["replay_margin"] <= tol_logits,
            "pool_shared": all(r["pool_shared"]),
            "handoffs": rep.handoff["handoffs"] == len(r["trace"]),
            "transferred": r["transferred_each"]
            and rep.handoff["blocks_transferred"] == r["handed_private"]
            > 0,
            "same_ids": r["same_ids"],
            "ledger_unchanged": r["ledger_unchanged"],
            "no_device_op": not any(r["device_ops"]),
            "decode_tq_1": r["decode_tq"] == [1],
            "drained": r["drained"]}

    fused = {}
    for quant in (True, False):
        extra = ["--kv-quant", "int8"] if quant else []
        fused_eng = cli.build_server(parse_args(serve_args + extra), dev)[0]
        tr = trace(fused_eng.cfg.vocab_size)
        reset_counts()
        rep = fused_eng.serve(tr)
        fused[quant] = {"rep": rep, "launches": launch_counts(wrappers)}
    runs = {}
    with disagg_watch() as seen:
        for quant in (False, True):
            label = "int8" if quant else "exact"
            extra = ["--kv-quant", "int8"] if quant else []
            r = run(extra, seen, label)
            g = gates(r, fused[quant], quant)
            if "flight" in r:
                fg = pair_flight_gates(r)
                out["flight"] = {"gates": fg, **r["flight_summary"]}
                print(f"disagg flight recorder ({label}, armed; {card}): "
                      f"{json.dumps(r['flight_summary'])}; gates "
                      f"{json.dumps(fg)}", flush=True)
                if not all(fg.values()):
                    fail(f"disagg flight recorder: {fg}")
                lgg = pair_ledger_gates(r)
                out["ledger"] = {"gates": lgg, **r["ledger_summary"]}
                print(f"disagg request ledger ({label}, armed; {card}): "
                      f"handoff_s {r['ledger_summary']['handoff_s']}, "
                      f"aggregates {json.dumps(r['rep'].requests)}; gates "
                      f"{json.dumps(lgg)}", flush=True)
                if not all(lgg.values()):
                    fail(f"disagg request ledger: {lgg}")
            decode_kernel = ("flash_decode_paged_q8q_tick" if quant
                             else "flash_decode_paged_tick")
            rec = {k: r[k] for k in (
                "launches", "wall_s", "pool_shared", "handoff", "leaks",
                "handed_private", "device_ops", "decode_tq",
                "tokens_equal_fused", "tokens", "replay_margin")}
            rec.update(gates=g, tokens_per_sec=[
                r["rep"].tokens_per_sec, fused[quant]["rep"].tokens_per_sec],
                tbt_p95_s=[r["rep"].latency_percentiles()["tbt_p95_s"],
                           fused[quant]["rep"].latency_percentiles()[
                               "tbt_p95_s"]],
                ttft_p50_s=[r["rep"].latency_percentiles()["ttft_p50_s"],
                            fused[quant]["rep"].latency_percentiles()[
                                "ttft_p50_s"]],
                fused_launches=fused[quant]["launches"])
            runs[label] = rec
            print(f"disagg serve {label} ({card}): 16 requests, 2 prefill + "
                  f"6 decode slots: tokens equal to the fused serve "
                  f"{r['tokens_equal_fused']} of {r['tokens']} (replay "
                  f"margin {r['replay_margin']:.3e}, tol {tol_logits}), "
                  f"handoff {json.dumps(r['handoff'])}, handed-off private "
                  f"blocks {r['handed_private']}, device ops in the traced "
                  f"handoffs {r['device_ops']}, decode-worker Tq "
                  f"{r['decode_tq']}, pools shared {r['pool_shared']}, "
                  f"tok/s disagg/fused "
                  f"{[round(x, 1) for x in rec['tokens_per_sec']]}, TBT p95 "
                  f"{rec['tbt_p95_s']}, TTFT p50 {rec['ttft_p50_s']}, "
                  f"launches {json.dumps(r['launches'])}, gates {g}",
                  flush=True)
            if not all(g.values()):
                fail(f"disagg gates ({label}): {g}: {rec}")
            if on_card and not (r["launches"].get("flash_fwd")
                                and r["launches"].get(decode_kernel)):
                fail(f"disagg serve ({label}): B3 or the decode tick body "
                     f"never launched: {r['launches']}")
            del r
            torch.cuda.empty_cache() if on_card else None
    out["runs"] = runs
    # The timings: the watch traces handoffs inside the watched serves, so
    # an exact pair is served again unwatched, in turns (after a short
    # warm-up of the fresh pair).
    pair_eng = cli.build_server(parse_args(serve_args + DISAGG_ARGS), dev)[0]
    pair_eng.serve(trace(pair_eng.cfg.vocab_size)[:2])
    timed = {"disagg": [], "fused": []}
    for label in ("disagg", "fused", "disagg", "fused"):
        eng = pair_eng if label == "disagg" else fused_eng
        # The client's side: each request's on_token times, so the pair's
        # inter-token gaps are read as a stream sees them, the serialized
        # prefill ticks included (its report's TBT leaves them out).
        stamps = {}

        def stamped(r):
            got = stamps.setdefault(r.uid, [])
            return dataclasses.replace(
                r, on_token=lambda tok: got.append(time.monotonic()))

        t_rep = eng.serve([stamped(r) for r in trace(eng.cfg.vocab_size)])
        if on_card:
            torch.cuda.synchronize()
        lat = t_rep.latency_percentiles()
        gaps = sorted(b - a for ts in stamps.values()
                      for a, b in zip(ts, ts[1:]))
        timed[label].append({
            "tokens_per_sec": t_rep.tokens_per_sec,
            "ttft_p50_s": lat["ttft_p50_s"], "tbt_p50_s": lat["tbt_p50_s"],
            "tbt_p95_s": lat["tbt_p95_s"],
            "client_tbt_p50_s": gaps[len(gaps) // 2],
            "client_tbt_p95_s": gaps[min(len(gaps) - 1,
                                         int(0.95 * len(gaps)))],
            "wall_s": t_rep.wall_s,
            **({k: t_rep.handoff[k] for k in ("prefill_tick_s",
                                              "decode_tick_s")}
               if t_rep.handoff else {})})
    out["timed_unwatched"] = timed
    print(f"disagg ({card}), unwatched exact serves in turns (disagg, "
          f"fused, disagg, fused; tbt: the report's, for the pair the decode "
          f"worker's own tick time; client_tbt: the gaps between a stream's "
          f"on_token callbacks): " + json.dumps(
              {k: [{m: round(x, 5) for m, x in r.items()} for r in v]
               for k, v in timed.items()}), flush=True)
    del pair_eng, fused_eng
    out["wall_s_clean"] = time.monotonic() - t_phase
    for fault in faults:
        with disagg_watch(fault) as fseen:
            # The faults sit in the handoff, which every request takes:
            # the first 8 of the trace show them.
            r = run([], fseen, f"fault {fault}", requests=8)
            g = gates(r, fused[False], False)
        out["faults"][fault] = [k for k, v in g.items() if not v]
        print(f"disagg planted fault {fault!r} ({card}): gates that "
              f"rejected it {out['faults'][fault]}", flush=True)
        if not out["faults"][fault]:
            fail(f"disagg phase: every gate passed the planted fault "
                 f"{fault!r}")
        del r
    # The ledger's planted fault: a ledger that drops ``park`` (4 requests
    # of the trace, the ledger armed).
    obs.REQLOG.park = lambda uid, now=None: None
    try:
        with disagg_watch() as fseen:
            r = run([], fseen, "fault park", requests=4, ledger=True)
    finally:
        del obs.REQLOG.park
    lgg = pair_ledger_gates(r)
    out["faults"]["ledger_drops_park"] = [k for k, v in lgg.items() if not v]
    print(f"disagg planted fault 'ledger drops park' ({card}): handoff_s "
          f"{r['ledger_summary']['handoff_s']}, gates that rejected it "
          f"{out['faults']['ledger_drops_park']}", flush=True)
    if not out["faults"]["ledger_drops_park"]:
        fail("disagg phase: the ledger gates passed a ledger that drops "
             "park")
    del r
    out["wall_s"] = time.monotonic() - t_phase
    print(f"disagg phase wall ({card}) {out['wall_s']:.2f}s", flush=True)
    return out


# Phase 3l: the fleet's trace: 4 shared 384-token prefixes, 4 tails each
# (prefix-major: each prefix's first request, then its repeats), 32 new
# tokens; its int8 leg: 2 prefixes x 2, 16 new tokens; the rolling
# restart's traffic: 8 cold prompts of 16 new tokens.
FLEET_ARGS = ["--prefix-cache", "--serve-fleet", "--replicas", "2"]
FLEET_PREFIXES, FLEET_PREFIX_LEN, FLEET_NEW = 4, 384, 32


def fleet_prompts(vocab: int, seed: int, prefixes: int = FLEET_PREFIXES,
                  per_prefix: int = 4) -> list:
    """``prefixes`` x ``per_prefix`` prompts, prefix-major: a shared
    384-token head and a distinct tail of 24 to 84 tokens each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, FLEET_PREFIX_LEN).tolist()
             for _ in range(prefixes)]
    return [heads[p] + rng.integers(0, vocab, 24 + 16 * j + 4 * p).tolist()
            for p in range(prefixes) for j in range(per_prefix)]


def affinity_gate(entries: list, per_prefix: int, block: int) -> dict:
    """``entries`` (the ledgers of a prefix-major trace, in order): every
    repeat of a prefix labelled with its first's replica and hitting the
    whole shared head there, every first cold."""
    head = FLEET_PREFIX_LEN // block * block
    firsts = entries[::per_prefix]
    return {
        "repeats_on_holder": all(
            e["replica"] == entries[i - i % per_prefix]["replica"]
            for i, e in enumerate(entries)),
        "repeats_hit_the_head": all(
            e["prefix_hit_tokens"] == (0 if i % per_prefix == 0 else head)
            for i, e in enumerate(entries)),
        "firsts_cold": all(e["prefix_hit_tokens"] == 0 for e in firsts),
    }


def ledger_gates(ledgers: list, streamed: list) -> dict:
    """Each finished ledger against its request: the prompt's tokens are
    the prefix hit plus the prefilled ones, the decoded tokens the ones
    streamed, and the in-span segments sum to the span (within 1e-5 s:
    ``as_dict`` rounds each of the four fields to 1e-6)."""
    return {
        "prompt_is_hit_plus_prefilled": all(
            lg["prompt_tokens"] == lg["prefix_hit_tokens"]
            + lg["tokens_prefilled"] for lg in ledgers),
        "decoded_equal_streamed": [lg["tokens_decoded"] for lg in ledgers]
        == list(streamed),
        "segments_sum_to_span": all(
            abs(lg["prefill_s"] + lg["handoff_s"] + lg["decode_s"]
                - lg["wall_s"]) <= 1e-5 for lg in ledgers),
        "finished": all(lg["outcome"] in ("budget", "eos")
                        for lg in ledgers),
    }


def fleet_phase(dev, card, serve_args, wrappers, reset_counts,
                tol_logits) -> dict:
    """Phase 3l: the in-process fleet with the request ledger armed. Two
    :class:`LocalReplica` engines from one ``cli.engine_factory`` (one
    copy of the parameters on the card, a block pool each) behind a
    :class:`FleetRouter` on 127.0.0.1, the prefix cache on:

    (a) the 16-request fleet trace, one request at a time (SSE and whole
        bodies alternating), each request's launches read alone;
    (b) the router's ``/requests`` and the process's telemetry endpoint's
        ``/request/{uid}`` (in-process replicas record into one ledger);
    (c) a rolling restart under 8 concurrent cold requests;
    (d) the planted fault: the router with affinity ignored, on 2 fresh
        prefixes x 2;
    (e) the same 16 requests on two fresh engines without the router, each
        serving its replica's requests one after the other;
    (f) ``--kv-quant int8``: 2 prefixes x 2 through a fresh fleet and
        again on two direct engines (B5);
    (g) the CLI: ``cli.main`` with ``--serve-fleet --replicas 2
        --prefix-cache --metrics-port 0`` and no ``--device`` on this
        thread, 2 prefixes x 2 (4 new tokens) from a client thread, then
        SIGTERM: the record names the card, the router's 2 affinity
        routes, clean leak reports; ``/requests`` every uid once.

    Gates: the replicas read one parameter tensor set; every routed
    stream equal to its direct twin's tokens and every replica's launches
    (B2's tick and multi-row bodies, B3; B5 under int8) equal to its
    twin's; every repeat on its first's replica with the whole shared
    head hit (the router's ``affinity`` count 12, the replicas'
    ``ServeReport.prefix`` reuse the ledgers' hits); the ledgers
    reconciled (:func:`ledger_gates`); ``/requests`` every uid once with
    its replica's label, ``/request/{uid}`` the same ledger; the roll
    drained both replicas leak-free and dropped nothing; the fault
    rejected by :func:`affinity_gate`."""
    import numpy as np
    import torch

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch import obs
    from tree_attention_tpu_torch.models import named_params
    from tree_attention_tpu_torch.obs.http import MetricsHTTPServer
    from tree_attention_tpu_torch.serving import (
        FleetRouter,
        FleetSupervisor,
        LocalReplica,
        Request,
    )
    from tree_attention_tpu_torch.utils.config import parse_args

    on_card = dev.type == "cuda"
    t_phase = time.monotonic()
    out = {"card": card}

    class KeptReplica(LocalReplica):
        """A replica that keeps each drained ingress's ``ServeReport``."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.reports = []

        def await_drained(self, timeout_s=60.0):
            with self._lock:
                ing = self._ingress
            ok = super().await_drained(timeout_s)
            if ok and ing is not None and ing.report is not None:
                self.reports.append(ing.report)
            return ok

    def settle(router):
        t_w = time.monotonic()
        while time.monotonic() - t_w < 30 and any(
                v["inflight"] for v in router.stats()["replicas"].values()):
            time.sleep(0.005)

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def sequential(port, router, prompts, n_new):
        """One request at a time; each one's client view and launches."""
        runs = []
        for i, p in enumerate(prompts):
            reset_counts()
            cl = _http_client(port, {"prompt": p, "max_tokens": n_new},
                              stream=i % 2 == 0)
            settle(router)
            sync()
            runs.append({"client": cl, "launches": launch_counts(wrappers)})
        return runs

    def ledgers_of(port, runs):
        snap = json.loads(_http_get(port, "/requests")[1])
        by_uid = {}
        for e in snap["live"] + snap["recent"]:
            by_uid.setdefault(e["uid"], []).append(e)
        return snap, by_uid, [by_uid[r["client"]["uid"]][0] for r in runs]

    def add(total, launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def direct(make_engine, prompts, n_new, owners):
        """Each replica's requests on a fresh engine of its own, one after
        the other: tokens and summed launches per replica."""
        toks, launches = {}, {}
        for name in sorted(set(owners)):
            eng = make_engine()
            launches[name] = {}
            for i, p in enumerate(prompts):
                if owners[i] != name:
                    continue
                reset_counts()
                rep = eng.serve([Request(uid=100000 + i,
                                         prompt=np.asarray(p, np.int32),
                                         max_new_tokens=n_new)])
                sync()
                add(launches[name], launch_counts(wrappers))
                toks[i] = [int(t) for t in rep.results[0].tokens]
            del eng
        return toks, launches

    def fleet_run(label, extra, prompts, n_new, per_prefix, roll):
        c = parse_args(serve_args + FLEET_ARGS + extra)
        make_engine, _, kernel = cli.engine_factory(c, dev)
        reps = [KeptReplica(f"r{i}", make_engine, max_queue=c.max_queue,
                            default_max_tokens=n_new) for i in range(2)]
        router = FleetRouter(block=c.prefix_block, affinity=True)
        sup = FleetSupervisor(reps, router=router, monitor_interval_s=0)
        obs.REQLOG.arm()
        mhttp = MetricsHTTPServer(0)
        mport = mhttp.start()
        port = sup.start()
        r = {"label": label}
        try:
            e0, e1 = sup.engines
            r["one_param_copy"] = all(
                a.data_ptr() == b.data_ptr() for (_, a), (_, b) in zip(
                    named_params(e0.params), named_params(e1.params)))
            t0 = time.monotonic()
            runs = sequential(port, router, prompts, n_new)
            r["sequential_wall_s"] = time.monotonic() - t0
            snap, by_uid, entries = ledgers_of(port, runs)
            owners = [e["replica"] for e in entries]
            r["owners"] = owners
            r["routed"] = router.stats()["routed"]
            detail = [json.loads(_http_get(mport, f"/request/{e['uid']}")[1])
                      for e in entries]
            fleet_launches = {n: {} for n in ("r0", "r1")}
            for run, name in zip(runs, owners):
                add(fleet_launches[name], run["launches"])
            r["launches"] = fleet_launches
            r["streams"] = [run["client"]["tokens"] for run in runs]
            r["gates"] = {
                "all_200": all(run["client"]["statuses"] == [200]
                               for run in runs),
                "one_param_copy": r["one_param_copy"],
                "uids_once": all(len(v) == 1 for v in by_uid.values())
                and len(by_uid) == len(snap["live"]) + len(snap["recent"]),
                "labelled_with_a_replica": set(owners) == {"r0", "r1"},
                "request_detail_equal": all(
                    {k: v for k, v in e.items() if k != "replica"} == d
                    for e, d in zip(entries, detail)),
                **affinity_gate(entries, per_prefix, c.prefix_block),
                **ledger_gates(entries, [len(s) for s in r["streams"]]),
                "router_affinity_count": r["routed"]["affinity"]
                == len(prompts) - len(prompts) // per_prefix,
            }
            r["ledgers"] = entries
            if roll:
                # (c) a rolling restart under 8 concurrent cold requests.
                rng = np.random.default_rng(7)
                cold = [rng.integers(0, c.vocab_size, 96 + 8 * i).tolist()
                        for i in range(8)]
                roll_out = {}

                def do_roll():
                    time.sleep(0.05)
                    roll_out.update(sup.rolling_restart())

                import threading

                th = threading.Thread(target=do_roll)
                th.start()
                t0 = time.monotonic()
                traffic = _in_threads([(_http_client, dict(
                    port=port, body={"prompt": p, "max_tokens": 16},
                    stream=i % 2 == 0)) for i, p in enumerate(cold)])
                th.join(300)
                settle(router)
                r["roll_wall_s"] = time.monotonic() - t0
                st = router.stats()
                r["roll"] = {"replicas": roll_out, "requeued": st["requeued"],
                             "dropped": st["dropped"],
                             "statuses": [cl["statuses"] for cl in traffic]}
                r["gates"].update({
                    "roll_both_drained": sorted(roll_out) == ["r0", "r1"]
                    and all(v.get("drained") for v in roll_out.values()),
                    "roll_leak_free": all(leaks_clean(v["leak"])
                                          for v in roll_out.values()),
                    "roll_dropped_nothing": st["dropped"] == 0 and all(
                        cl["statuses"][-1] == 200 and cl["finish"] == "length"
                        and len(cl["tokens"]) == 16 for cl in traffic),
                    "roll_rejoined": [v["state"] for v in
                                      st["replicas"].values()] == ["up",
                                                                   "up"],
                })
                # The replicas' own prefix reports (their first drained
                # run: the sequential pass, then cold roll traffic).
                reused = {n: rep.reports[0].prefix["tokens_reused"]
                          for n, rep in sup.replicas.items()}
                hits = {n: sum(e["prefix_hit_tokens"] for e in entries
                               if e["replica"] == n) for n in reused}
                r["prefix_reports"] = {n: rep.reports[0].prefix
                                       for n, rep in sup.replicas.items()}
                r["gates"]["prefix_reports_equal_ledgers"] = reused == hits
                # (d) the planted fault: affinity ignored.
                fresh = fleet_prompts(c.vocab_size, 99, prefixes=2,
                                      per_prefix=2)
                router.affinity = False
                fruns = sequential(port, router, fresh, 4)
                router.affinity = True
                fentries = ledgers_of(port, fruns)[2]
                fg = affinity_gate(fentries, 2, c.prefix_block)
                r["fault_affinity_ignored"] = {
                    "owners": [e["replica"] for e in fentries],
                    "gates": fg, "rejected": not all(fg.values())}
        finally:
            sup.stop()
            mhttp.stop()
            obs.REQLOG.disarm()
        r["leaks"] = sup.leak_reports()
        r["gates"]["leak_free_at_stop"] = all(
            leaks_clean(v) for v in r["leaks"].values())
        del sup, reps, e0, e1
        if on_card:
            torch.cuda.empty_cache()
        toks, dlaunches = direct(make_engine, prompts, n_new, owners)
        r["direct_launches"] = dlaunches
        r["gates"]["streams_equal_direct"] = [
            toks[i] for i in range(len(prompts))] == r["streams"]
        r["gates"]["launches_equal_direct"] = dlaunches == r["launches"]
        if on_card:
            # B2's tick body (B5's under int8) and B3 on each replica.
            tick = ("flash_decode_paged_q8q_tick" if kernel else
                    "flash_decode_paged_tick")
            r["gates"]["kernels_launched"] = all(
                n.get(tick) and n.get("flash_fwd")
                for n in r["launches"].values())
        r["kernel"] = kernel
        return r

    c = parse_args(serve_args + FLEET_ARGS)
    vocab = c.vocab_size
    exact = fleet_run("exact", [], fleet_prompts(vocab, 5), FLEET_NEW, 4,
                      roll=True)
    int8 = fleet_run("int8", ["--kv-quant", "int8"],
                     fleet_prompts(vocab, 6, prefixes=2, per_prefix=2), 16,
                     2, roll=False)
    for r in (exact, int8):
        lab = r["label"]
        print(f"fleet {lab} ({card}; 2 replicas sharing the one card: not a "
              f"scaling figure): owners {r['owners']}, routed "
              f"{json.dumps(r['routed'])}, sequential wall "
              f"{r['sequential_wall_s']:.2f}s, launches per replica "
              f"{json.dumps(r['launches'])} (direct twins "
              f"{json.dumps(r['direct_launches'])}), leaks "
              f"{json.dumps(r['leaks'])}; gates {json.dumps(r['gates'])}",
              flush=True)
        if not all(r["gates"].values()):
            fail(f"fleet {lab}: {r['gates']}")
    lg = exact["ledgers"]
    print(f"fleet ledgers ({card}): prompt/hit/prefilled/decoded "
          f"{[[e['prompt_tokens'], e['prefix_hit_tokens'], e['tokens_prefilled'], e['tokens_decoded']] for e in lg]}; "
          f"prefill/decode s p50 "
          f"{sorted(e['prefill_s'] for e in lg)[len(lg) // 2]:.4f} / "
          f"{sorted(e['decode_s'] for e in lg)[len(lg) // 2]:.4f}; "
          f"replica prefix reports {json.dumps(exact['prefix_reports'])}",
          flush=True)
    print(f"fleet rolling restart ({card}): {json.dumps(exact['roll'])} "
          f"wall {exact['roll_wall_s']:.2f}s", flush=True)
    f = exact["fault_affinity_ignored"]
    print(f"fleet planted fault 'affinity ignored' ({card}): owners "
          f"{f['owners']}, gates {json.dumps(f['gates'])} (the gate must "
          f"reject it)", flush=True)
    if not f["rejected"]:
        fail("fleet: the affinity gate passed a router that ignores "
             "affinity")
    out["cli"] = fleet_cli(serve_args, card, vocab)
    for r in (exact, int8):
        r.pop("streams")
    out.update(exact=exact, int8=int8)
    out["wall_s"] = time.monotonic() - t_phase
    print(f"fleet phase wall ({card}) {out['wall_s']:.2f}s", flush=True)
    return out


def fleet_cli(serve_args, card, vocab) -> dict:
    """Phase 3l (g): ``python -m tree_attention_tpu_torch --mode serve
    --serve-fleet --replicas 2 --prefix-cache`` in this process
    (``cli.main`` on the main thread, which takes SIGTERM), driven by a
    client thread that learns the router's port from
    ``FleetSupervisor.start``, sends 2 prefixes x 2 requests one at a
    time, reads ``/requests`` and sends SIGTERM; the record read from
    ``cli.main``'s stdout."""
    import signal
    import threading

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.serving import FleetSupervisor

    prompts = fleet_prompts(vocab, 8, prefixes=2, per_prefix=2)
    started, seen = [], {}
    start = FleetSupervisor.start

    def recorded_start(self):
        port = start(self)
        started.append(port)
        return port

    def client():
        t_w = time.monotonic()
        while not started and time.monotonic() - t_w < 300:
            time.sleep(0.01)
        try:
            seen["clients"] = [_http_client(started[0], {
                "prompt": p, "max_tokens": 4}, stream=i % 2 == 0)
                for i, p in enumerate(prompts)]
            seen["requests"] = json.loads(
                _http_get(started[0], "/requests")[1])
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    FleetSupervisor.start = recorded_start
    th = threading.Thread(target=client)
    buf = io.StringIO()
    t0 = time.monotonic()
    try:
        th.start()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(serve_args + ["--serve-fleet", "--replicas", "2",
                                        "--prefix-cache", "--metrics-port",
                                        "0", "--log-level", "warning"])
    finally:
        FleetSupervisor.start = start
        th.join(60)
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    snap = seen.get("requests") or {"live": [], "recent": []}
    uids = [e["uid"] for e in snap["live"] + snap["recent"]]
    fl = rec["fleet"]
    gates = {
        "exit_0": rc == 0,
        "on_the_card": rec["device"] == card.split(",")[0].strip(),
        "all_200_with_4_tokens": all(
            cl["statuses"] == [200] and len(cl["tokens"]) == 4
            for cl in seen.get("clients", [])) and len(seen["clients"]) == 4,
        "router_affinity_2": fl["router"]["routed"]["affinity"] == 2,
        "leak_free": all(leaks_clean(v) for v in fl["leaks"].values()),
        "requests_once_labelled": len(uids) == len(set(uids)) == 4
        and {e["replica"] for e in snap["recent"]} <= {"r0", "r1"},
    }
    out = {"record": {k: rec[k] for k in ("device", "fleet")},
           "wall_s": time.monotonic() - t0, "gates": gates}
    print(f"fleet CLI ({card}): --serve-fleet --replicas 2 --prefix-cache "
          f"on {rec['device']}: {json.dumps(out['record'])}; "
          f"{out['wall_s']:.2f}s; gates {json.dumps(gates)}", flush=True)
    if not all(gates.values()):
        fail(f"fleet CLI: {gates}")
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# The phases of main() in the order they run; ``--phases`` picks some. The
# build (phase 1) always runs; the report (phase 8) needs them all. A name
# on the left runs the phases on the right too: what it reads of theirs.
PHASES = ("2", "3", "3f", "3c", "3e", "4", "5", "6", "7", "3g", "3h", "3i",
          "3j", "3k", "3l")
PHASE_NEEDS = {"3b": ("3",), "3d": ("3",), "7": ("6", "7")}


def selected_phases(argv) -> set:
    """The phases ``argv`` names after ``--phases`` (comma- or
    space-separated, with what each needs), or all of them without the
    flag. An unknown name fails the run."""
    if "--phases" not in argv:
        if argv:
            fail(f"unknown arguments {argv} (only --phases NAME...)")
        return set(PHASES)
    names = [n for a in argv[argv.index("--phases") + 1:]
             for n in a.split(",") if n]
    extra = argv[:argv.index("--phases")]
    unknown = [n for n in names if n not in PHASES and n not in PHASE_NEEDS]
    if extra or unknown or not names:
        fail(f"unknown phase names {unknown or extra or names}: known "
             f"{list(PHASES) + sorted(set(PHASE_NEEDS) - set(PHASES))}")
    return {p for n in names for p in PHASE_NEEDS.get(n, (n,))}


def main() -> None:
    run = selected_phases(sys.argv[1:])
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    t_start = time.monotonic()
    print(f"phases: {[p for p in PHASES if p in run]}", flush=True)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F

    from tree_attention_tpu_torch import cli
    from tree_attention_tpu_torch.models import (
        forward_step,
        init_paged_cache,
    )
    from tree_attention_tpu_torch.ops import _build, cuda_attention
    from tree_attention_tpu_torch.ops import cuda_bwd, cuda_decode
    from tree_attention_tpu_torch.ops import flash_attention
    from tree_attention_tpu_torch.ops.block_utils import first_live_q
    from tree_attention_tpu_torch.ops.tuning import DKV_TILES
    from tree_attention_tpu_torch.ops.cuda_decode import gather_paged_kv
    from tree_attention_tpu_torch.serving import SlotServer, synthetic_trace
    from tree_attention_tpu_torch.utils.config import parse_args

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. build ---------------------------------------------------------
    t0 = time.monotonic()
    secs = _build.build()
    print(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
          f"wall {time.monotonic() - t0:.2f}s", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)  # the card's name and power limit, as given
    ptxas = ptxas_summary(_build)
    print(f"ptxas (registers, spill-store bytes): {json.dumps(ptxas)}",
          flush=True)
    # Every instantiation of the decode body (B1/B2/B4/B5), by mangled
    # name; the tree variants' template arguments end in ``ELb1EE``.
    dptx = ptxas_summary(_build, ("flash_decode",),
                         r"(_Z\w*decode_split_kernel\w*)",
                         lambda m: m.group(1))
    tree_bodies = {n: r for n, r in dptx.items() if "ELb1EEEv" in n}
    print(f"ptxas of the decode body: {len(dptx)} instantiations, "
          f"{len(tree_bodies)} tree variants; tree vs causal twin "
          f"(registers, spill-store bytes): " + json.dumps({
              n[n.index("kernelI") + 7:n.index("EEEv")]: [
                  r, dptx.get(n.replace("ELb1EEEv", "ELb0EEEv"))]
              for n, r in tree_bodies.items()}), flush=True)
    # The multi-row body (mma.sync) in its three libraries (bf16: B1, B2;
    # the cast route; q8q: B4, B5): registers and spills of each
    # instantiation (operands, layout, D, warps, tree, local), by mangled
    # name.
    by_lib = {lib: ptxas_summary(_build, (lib,),
                                 r"_Z\w*(decode_tiled_kernelI\w+?EE)v",
                                 lambda m: m.group(1))
              for lib in ("flash_decode_tiled", "flash_decode_tiled_cast",
                          "flash_decode_tiled_q8q")}
    tptx = {n: r for lib in by_lib.values() for n, r in lib.items()}
    per_lib = {lib: len(x) for lib, x in by_lib.items()}
    print(f"ptxas of the multi-row body (B1, B2, B4, B5, the cast route): "
          f"{len(tptx)} instantiations ({json.dumps(per_lib)}; registers, "
          f"spill-store bytes): {json.dumps(tptx)}", flush=True)
    # The tick body (B2 and B5's one-row paged launches): registers and
    # spills of each instantiation (operands, D, per-block scalars).
    kptx = ptxas_summary(_build, ("decode_tick",),
                         r"_Z\w*(decode_tick_kernelI\w+?EE)v",
                         lambda m: m.group(1))
    print(f"ptxas of the tick body (B2, B5, the cast route at one row): "
          f"{len(kptx)} instantiations (registers, spill-store bytes): "
          f"{json.dumps(kptx)}", flush=True)
    hgmma = hgmma_counts(_build)
    print(f"SASS HGMMA instructions of the tensor-core bodies: "
          f"{json.dumps(hgmma)}", flush=True)
    for body in ("flash_fwd_wgmma", "flash_dq_wgmma", "flash_dkv_wgmma"):
        if not any(body in n and c > 0 for n, c in hgmma.items()):
            fail(f"no HGMMA instruction in {body}_kernel's SASS")
    # The redesigned bodies keep every register: a spill would put the
    # accumulators (B7's dK and dV, the multi-row body's O) through local
    # memory.
    spills = {n: r for n, r in {**ptxas, **tptx, **kptx}.items()
              if ("dkv_wgmma" in n or "decode_t" in n) and r[1]}
    if spills or not tptx or len(kptx) != 10 or not any(
            "dkv_wgmma" in n for n in ptxas):
        fail(f"the new bodies spill or are missing from the build: "
             f"{json.dumps(spills)}")

    # -- 2. kernels against their plain versions ---------------------------
    g = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    cuda_act = torch.profiler.ProfilerActivity.CUDA
    cuda_dev = torch.autograd.DeviceType.CUDA

    def device_kernels(prof):
        """(name, ms) of every kernel the trace saw on the card."""
        return [(e.name, e.time_range.elapsed_us() / 1e3)
                for e in prof.events() if e.device_type == cuda_dev]

    def time_ms(fn, floor_ms, iters=10, names=None):
        """Device time of one call: the summed duration of the kernels it
        runs on the card (torch.profiler; with ``names``, only the kernels
        whose name holds one of them), mean of ``iters`` calls with the
        L2 flushed before each (a serving step finds the layer's KV cold);
        host launch gaps are excluded. The profiler on the card's machine
        now and then loses kernels, and a lost kernel only lowers a
        reading, so the larger of two traced runs is kept. ``floor_ms`` is
        the least time the card could take for the call's work (its bound):
        a reading below it has still lost kernels, and then — or if the
        profiler traces no device time — the median of CUDA events around
        each call is taken instead (launch gaps included); a reading still
        below the floor fails the run. Returns ``(ms, clock, call_ms)``:
        ``call_ms`` is every kernel of the same calls (or the CUDA-event
        time)."""
        fn()
        torch.cuda.synchronize()
        total = mine = 0.0
        for _ in range(2):
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU, cuda_act]) as prof:
                for _ in range(iters):
                    flush_buf.zero_()
                    fn()
                torch.cuda.synchronize()
            kernels = [(n, ms) for n, ms in device_kernels(prof)
                       if "FillFunctor<unsigned char>" not in n]
            run = sum(ms for _, ms in kernels)
            if run > total:
                total = run
                mine = sum(ms for n, ms in kernels
                           if names is None or any(x in n for x in names))
        if mine / iters >= floor_ms:
            return mine / iters, "profiler", total / iters
        if total > 0:
            print(f"time_ms: profiler read {mine / iters:.4f} ms, below "
                  f"the {floor_ms:.4f} ms bound; timing with CUDA events",
                  flush=True)
        times = []
        for _ in range(iters):
            flush_buf.zero_()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        ms = sorted(times)[len(times) // 2]
        if ms < floor_ms:
            fail(f"a call timed {ms:.4f} ms, below its {floor_ms:.4f} ms "
                 f"bound")
        return ms, "cuda_events", ms

    gate = rows_close

    def visible_pairs(qoff, tq, tk):
        """Sum over batch rows and queries of keys visible under the causal
        rule (kv_offset 0): min(tk, qoff + t + 1)."""
        return sum(max(0, min(tk, int(o) + t + 1))
                   for o in qoff.tolist() for t in range(tq))

    def gqa_mask(qoff, tq, tk):
        pos = qoff[:, None].long() + torch.arange(tq, device=dev)
        return (torch.arange(tk, device=dev)[None, None] <= pos[..., None]
                )[:, None]  # (B, 1, Tq, Tk) bool

    cases = []

    def record(kernel, name, fn, plain, library, bytes_, flops, *,
               ops_s=None, yardstick=None, names=None, parts=None):
        """Gate ``fn`` against ``plain`` and time both beside the bound
        (bytes / HBM rate or the operations' time — ``flops`` at the bf16
        rate, or ``ops_s`` seconds — the larger) and ``library``, one
        PyTorch call of the same function (None where there is none; then
        ``yardstick`` is timed instead, a labelled near-equivalent). With
        ``names`` ``ms`` counts only the kernel's own launches and
        ``call_ms`` the whole call's; ``parts`` (kernel name fragments) are
        also timed apart, as ``by_kernel_ms``."""
        a, b = fn(), plain()
        torch.cuda.synchronize()
        ok, eo, er, el = gate(a, b)
        if not ok:
            fail(f"{kernel} {name}: |dout| {eo:.3e}, relative {er:.3e} "
                 f"(tol {TOL_OUT_REL}), |dlse| {el:.3e} (tol {TOL_LSE})")
        t_ops = flops / BF16_FLOPS_PER_S if ops_s is None else ops_s
        bound = max(bytes_ / HBM_BYTES_PER_S, t_ops) * 1e3
        ms, clock, call_ms = time_ms(fn, bound, names=names)
        plain_ms, plain_clock, _ = time_ms(plain, bound, iters=3)
        lib_ms, lib_clock, _ = (time_ms(library, bound)
                                if library is not None else (None,) * 3)
        c = {
            "kernel": kernel, "case": name, "max_abs_err": eo,
            "max_rel_err": er, "max_abs_err_lse": el, "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound,
            "bound_by": ("bytes" if bytes_ / HBM_BYTES_PER_S >= t_ops
                         else "operations"),
            "clocks": [clock, plain_clock, lib_clock],
        }
        if names is not None:
            c["call_ms"] = call_ms
        if yardstick is not None:
            c["yardstick_sdpa_dequant_ms"] = time_ms(yardstick, bound)[0]
        if parts is not None:
            c["by_kernel_ms"] = {x: time_ms(fn, 0.0, names=(x,))[0]
                                 for x in parts}
        cases.append(c)
        lib = (f"sdpa {lib_ms:.4f}" if lib_ms is not None else
               f"library none, sdpa over dequantized bf16 "
               f"{c.get('yardstick_sdpa_dequant_ms', math.nan):.4f}")
        print(f"{kernel} {name}: |dout| {eo:.3e} relative {er:.3e} "
              f"|dlse| {el:.3e} (tol {TOL_OUT_REL}/{TOL_LSE}) ms {ms:.4f} "
              + (f"(whole call {c['call_ms']:.4f}) " if names else "")
              + (f"by kernel {json.dumps(c['by_kernel_ms'])} " if parts
                 else "")
              + f"plain {plain_ms:.4f} {lib} bound {bound:.4f} "
              f"({c['bound_by']}) clocks {c['clocks']}", flush=True)

    # -- shared by the phases: the wrappers and their counts, the
    # device split of a trace, the models' depths ----------------
    wrappers = {
        "flash_decode": cuda_decode.attention_cuda_decode,
        "flash_decode_paged": cuda_decode.attention_cuda_decode_paged,
        "flash_decode_q8q": cuda_decode.attention_cuda_decode_q8q,
        "flash_decode_paged_q8q": cuda_decode.attention_cuda_decode_paged_q8q,
        "flash_fwd": cuda_attention.attention_cuda_fwd,
        "flash_dq": cuda_bwd.attention_cuda_dq,
        "flash_dkv": cuda_bwd.attention_cuda_dkv,
    }

    def reset_counts():
        for w in wrappers.values():
            w.launches = 0
            for extra in ("tree_launches", "local_launches",
                          "tiled_launches", "cast_tiled_launches",
                          "tick_launches"):
                if hasattr(w, extra):
                    setattr(w, extra, 0)
            for by_tq in ("tiled_tq", "tree_tq"):
                if hasattr(w, by_tq):
                    getattr(w, by_tq).clear()

    # The multi-row body's launches of a serve, by kernel and Tq.
    multi_row = {"B1": cuda_decode.attention_cuda_decode,
                 "B2": cuda_decode.attention_cuda_decode_paged,
                 "B4": cuda_decode.attention_cuda_decode_q8q,
                 "B5": cuda_decode.attention_cuda_decode_paged_q8q}

    def tiled_by_tq():
        return {n: dict(sorted(w.tiled_tq.items()))
                for n, w in multi_row.items() if w.tiled_tq}

    serve_tiled = {}  # serve label -> tiled_by_tq()

    matmul = ("nvjet", "gemm", "gemv", "sm90", "cutlass", "cublas")

    def split_by(prof, groups):
        """Device ms of a trace by kernel group (the first group whose
        name fragment a kernel's name holds; "other" else), and by
        kernel."""
        by_kernel = {}
        for name, ms in device_kernels(prof):
            by_kernel[name] = by_kernel.get(name, 0.0) + ms
        split = {g: 0.0 for g in groups}
        split["other"] = 0.0
        for name, ms in by_kernel.items():
            low = name.lower()
            key = next((g for g, keys in groups.items()
                        if any(x.lower() in low for x in keys)), "other")
            split[key] += ms
        return split, by_kernel

    n_layers = parse_args(SERVE_ARGS).n_layers
    targs = parse_args(TRAIN_ARGS)

    # Each phase's wall: from its block's start to the next one's.
    wall_mark = {"phase": None, "t": time.monotonic()}

    def mark(phase):
        now = time.monotonic()
        if wall_mark["phase"] is not None:
            print(f"phase {wall_mark['phase']} wall "
                  f"{now - wall_mark['t']:.2f}s", flush=True)
        wall_mark.update(phase=phase, t=now)

    if "2" in run:
        mark("2")
        # The decode kernels' own launches: a body and the merge (the tick body
        # merges inside its launch).
        own = ("decode_split", "decode_tiled", "decode_tick", "merge_splits")

        # B1: the reference workload (the --mode decode shape) ...
        q, k, v = rnd(1, 16, 1, 128), rnd(1, 16, 64000, 128), rnd(1, 16, 64000, 128)
        kv_bytes = 2 * k.numel() * 2
        record("flash_decode", "ref B1 H16 Tk64000 Tq1",
               lambda: cuda_decode.attention_cuda_decode(q, k, v),
               lambda: cuda_decode.decode_plain(q, k, v),
               lambda: F.scaled_dot_product_attention(q, k, v),
               kv_bytes + 2 * q.numel() * 2, 4.0 * 16 * 64000 * 128,
               parts=("decode_split", "merge_splits"))
        # The gate has teeth at this shape: it rejects an output off by half,
        # and one split's keys left out of the merge (the wrapper cuts 64000
        # keys into splits of 256 here).
        plain = cuda_decode.decode_plain(q, k, v)
        o, l = cuda_decode.attention_cuda_decode(q, k, v)
        half = gate((o * 0.5, l), plain)
        dropped = gate(cuda_decode.decode_plain(q, k[:, :, 256:], v[:, :, 256:]),
                       plain)
        print(f"gate: output halved -> relative |dout| {half[2]:.3e}; one split "
              f"dropped -> |dlse| {dropped[3]:.3e}; both rejected: "
              f"{not (half[0] or dropped[0])}", flush=True)
        if half[0] or dropped[0]:
            fail("the parity gate accepts a planted fault at the reference shape")
        del plain, o, l
        # ... and a ragged GQA batch: Tq 1 on the split body, Tq 16 (64 packed
        # rows a KV head, a staged int8 prompt tail's shape) on the multi-row
        # body.
        for tq in (1, 16):
            q, k, v = rnd(8, 32, tq, 128), rnd(8, 8, 4096, 128), rnd(8, 8, 4096, 128)
            qoff = torch.randint(0, 4096 - tq, (8,), generator=g, device=dev,
                                 dtype=torch.int32)
            need = sum(min(4096, int(o) + tq) for o in qoff.tolist())
            mask = gqa_mask(qoff, tq, 4096)
            record("flash_decode" if tq == 1 else "flash_decode_tiled",
                   f"GQA B8 Hq32 Hkv8 Tk4096 Tq{tq} ragged",
                   lambda: cuda_decode.attention_cuda_decode(
                       q, k, v, causal=True, q_offset=qoff),
                   lambda: cuda_decode.decode_plain(q, k, v, causal=True,
                                                    q_offset=qoff),
                   lambda: F.scaled_dot_product_attention(
                       q, k, v, attn_mask=mask, enable_gqa=True),
                   need * 8 * 128 * 2 * 2 + 2 * q.numel() * 2,
                   4.0 * 32 * 128 * visible_pairs(qoff, tq, 4096), names=own,
                   parts=(("decode_tiled", "merge_splits") if tq > 1 else None))

        # B2: a fragmented 64-token-block pool at the serve shapes (8 slots,
        # 16 heads x 128, 10-block tables = 640-token slots), the decode tick
        # (the tick body; more rows take the multi-row body, phase 2e).
        def ticked(wrapper, fn):
            """``fn()``, failing unless it launched ``wrapper``'s tick body
            exactly once."""
            before = wrapper.tick_launches
            out = fn()
            if wrapper.tick_launches != before + 1:
                fail(f"a one-row paged call did not run the tick body once "
                     f"({wrapper.tick_launches - before} tick launches)")
            return out

        b2t = cuda_decode.attention_cuda_decode_paged
        b5t = cuda_decode.attention_cuda_decode_paged_q8q
        blk, nb, npool = 64, 10, 96
        kp, vp = rnd(npool, 16, blk, 128), rnd(npool, 16, blk, 128)
        table = torch.stack([torch.randperm(npool, generator=g, device=dev)[:nb]
                             for _ in range(8)]).to(torch.int32)
        for tq in (1,):
            q = rnd(8, 16, tq, 128)
            qoff = torch.randint(0, nb * blk - tq, (8,), generator=g, device=dev,
                                 dtype=torch.int32)
            need = sum(min(nb * blk, int(o) + tq) for o in qoff.tolist())
            kg, vg = gather_paged_kv(kp, vp, table)
            mask = gqa_mask(qoff, tq, nb * blk)
            record("flash_decode_paged_tick", f"B8 H16 block64 NB10 Tq{tq} ragged",
                   lambda: ticked(b2t, lambda: b2t(q, kp, vp, table,
                                                   q_offset=qoff)),
                   lambda: cuda_decode.paged_decode_plain(q, kp, vp, table,
                                                          q_offset=qoff),
                   lambda: F.scaled_dot_product_attention(q, kg, vg,
                                                          attn_mask=mask),
                   need * 16 * 128 * 2 * 2 + 2 * q.numel() * 2,
                   4.0 * 16 * 128 * visible_pairs(qoff, tq, nb * blk),
                   names=own)

        # -- 2a. the int8 routes: B4, B5, and B1/B2 over int8 K/V -------------
        # Bound: the visible int8 K+V bytes (to each row's causal frontier),
        # plus Q, the scales and the output; operations: the q.k products at
        # the int8 rate (q8q) or the bf16 rate (cast), the p.v products at the
        # bf16 rate. No PyTorch call computes int8-KV attention (library none);
        # SDPA over the dequantized bf16 K/V is timed as a yardstick: the same
        # result to within quantization, at twice the K/V bytes.

        def q8_ops_s(pairs, q8q):
            qk = INT8_OPS_PER_S if q8q else BF16_FLOPS_PER_S
            return 2.0 * 128 * pairs / qk + 2.0 * 128 * pairs / BF16_FLOPS_PER_S

        def deq(codes, scale):
            return (codes.float() * scale).to(torch.bfloat16)

        q = rnd(1, 16, 1, 128)
        kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
            rnd(1, 16, 64000, 128), rnd(1, 16, 64000, 128))
        kd, vd = deq(kq, ks), deq(vq, vs)
        ref_q8_bytes = 2 * kq.numel() + q.numel() * 4 + 4 * ks.numel() * 4
        for kernel, route in (("flash_decode_q8q", "q8q"),
                              ("flash_decode", "q8")):
            record(kernel, "int8 ref B1 H16 Tk64000 Tq1",
                   lambda: cuda_decode.resolve_q8_kernel(route)(
                       q, kq, vq, ks, vs),
                   lambda: cuda_decode.resolve_q8_kernel(route, plain=True)(
                       q, kq, vq, ks, vs),
                   None, ref_q8_bytes, 0.0,
                   ops_s=q8_ops_s(16 * 64000, route == "q8q"),
                   yardstick=lambda: F.scaled_dot_product_attention(q, kd, vd),
                   names=own, parts=("decode_split", "merge_splits"))
        del kq, vq, kd, vd
        # (B4 with more than one packed row runs the multi-row body: phase 2g.)
        # B5 and B2-int8 at the serve decode tick: 8 slots of 640 tokens in
        # 64-token blocks of a fragmented pool, ragged lengths. The pool's
        # blocks carry magnitudes that differ from block to block, so their
        # per-block scales differ as a served cache's do.
        x = (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
             * torch.exp(0.7 * torch.randn((npool, 16, 1, 1), generator=g,
                                           device=dev)))
        kp8, kbs = cuda_decode.quantize_symmetric_int8(
            x.reshape(npool, 16, blk * 128), 2)
        x = (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
             * torch.exp(0.7 * torch.randn((npool, 16, 1, 1), generator=g,
                                           device=dev)))
        vp8, vbs = cuda_decode.quantize_symmetric_int8(
            x.reshape(npool, 16, blk * 128), 2)
        kp8, vp8 = (t.reshape(npool, 16, blk, 128) for t in (kp8, vp8))
        kbs, vbs = kbs[..., 0], vbs[..., 0]
        q = rnd(8, 16, 1, 128)
        qoff = torch.randint(0, nb * blk - 1, (8,), generator=g, device=dev,
                             dtype=torch.int32)
        need = sum(min(nb * blk, int(o) + 1) for o in qoff.tolist())
        mask = gqa_mask(qoff, 1, nb * blk)
        kg, vg = gather_paged_kv(deq(kp8, kbs[..., None, None]),
                                 deq(vp8, vbs[..., None, None]), table)
        tick_bytes = need * 16 * 128 * 2 + q.numel() * 4
        serve_q8 = (q, kp8, vp8, table, kbs, vbs, qoff)
        record("flash_decode_paged_q8q_tick", "int8 B8 H16 block64 NB10 Tq1 "
               "ragged, per-block scales",
               lambda: ticked(b5t, lambda: b5t(q, kp8, vp8, table, kbs, vbs,
                                               q_offset=qoff)),
               lambda: cuda_decode.paged_decode_q8q_plain(
                   q, kp8, vp8, table, kbs, vbs, q_offset=qoff),
               None, tick_bytes + 2 * 8 * nb * 16 * 4, 0.0,
               ops_s=q8_ops_s(16 * visible_pairs(qoff, 1, nb * blk), True),
               yardstick=lambda: F.scaled_dot_product_attention(
                   q, kg, vg, attn_mask=mask), names=own)
        record("flash_decode_paged_tick", "int8 B8 H16 block64 NB10 Tq1 ragged, "
               "block_scales",
               lambda: ticked(b2t, lambda: b2t(q, kp8, vp8, table, q_offset=qoff,
                                               block_scales=(kbs, vbs))),
               lambda: cuda_decode.paged_decode_plain(
                   q, kp8, vp8, table, q_offset=qoff, block_scales=(kbs, vbs)),
               None, tick_bytes + 2 * 8 * nb * 16 * 4, 0.0,
               ops_s=q8_ops_s(16 * visible_pairs(qoff, 1, nb * blk), False),
               yardstick=lambda: F.scaled_dot_product_attention(
                   q, kg, vg, attn_mask=mask), names=own)
        cks, cvs = (torch.rand((8, 16, 1, 128), generator=g, device=dev) * 0.03
                    + 0.005 for _ in range(2))
        kg, vg = gather_paged_kv(kp8, vp8, table)
        kg, vg = deq(kg, cks), deq(vg, cvs)
        record("flash_decode_paged_q8q_tick", "int8 B8 H16 block64 NB10 Tq1 "
               "ragged, channel scales",
               lambda: ticked(b5t, lambda: b5t(q, kp8, vp8, table, cks, cvs,
                                               q_offset=qoff)),
               lambda: cuda_decode.paged_decode_q8q_plain(
                   q, kp8, vp8, table, cks, cvs, q_offset=qoff),
               None, tick_bytes + 2 * cks.numel() * 4, 0.0,
               ops_s=q8_ops_s(16 * visible_pairs(qoff, 1, nb * blk), True),
               yardstick=lambda: F.scaled_dot_product_attention(
                   q, kg, vg, attn_mask=mask), names=own)
        del kg, vg, mask, x

        # The gate has teeth at B5's serve shape: B5's arithmetic written out
        # here from the gathered view passes it, and with a planted per-block
        # scale fault it is rejected — scales read by logical block j instead
        # of table[b, j], and the V scalar applied before the softmax sum l.
        def q8q_paged_here(case, fault=None, route="q8q"):
            """B5 (``route`` "q8q"; "q8": B2's cast route) with per-block
            scales on ``case`` = (q, K and V pools, table, K and V scales,
            q_offset), written out from the gathered view; a packed row r sits
            at q_offset + r % Tq."""
            q, kp, vp, tbl, ksc, vsc, qo = case
            B, NB = tbl.shape
            blk, hkv, tq = kp.shape[2], kp.shape[1], q.shape[2]
            if route == "q8q":
                codes, qs = cuda_decode._fold_quantize_q(q, hkv, None, None)
            else:  # a bf16 Q and the softmax scale
                codes = q.to(torch.bfloat16).reshape(B, hkv, -1, q.shape[3])
                qs = q.shape[3] ** -0.5
            kg, vg = gather_paged_kv(kp, vp, tbl)
            idx = (torch.arange(NB, device=dev).expand(B, NB)
                   if fault == "logical" else tbl.long())
            kk, vk = (sc[idx].transpose(1, 2).repeat_interleave(blk, 2)[
                :, :, None] for sc in (ksc, vsc))
            s = torch.einsum("bhrd,bhkd->bhrk", codes.float(), kg.float()) \
                * qs * kk
            pos = qo.long()[:, None] + torch.arange(codes.shape[2],
                                                    device=dev) % tq
            vis = (torch.arange(NB * blk, device=dev)[None, None, None]
                   <= pos[:, None, :, None])
            s = s.masked_fill(~vis, -math.inf)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            if fault == "v_early":
                p = p * vk
            den = p.sum(-1)
            if fault != "v_early":
                p = p * vk
            acc = torch.einsum("bhrk,bhkd->bhrd",
                               p.to(torch.bfloat16).float(), vg.float())
            return ((acc / den[..., None]).to(torch.bfloat16).reshape(q.shape),
                    (m[..., 0] + torch.log(den)).reshape(q.shape[:3]))

        def q8q_teeth(case, kernel, route="q8q"):
            """The gate against B5's plain version (``route`` "q8": B2's with
            ``block_scales``) on ``case``: the arithmetic written out here, its
            two planted scale faults, and ``kernel``'s output halved."""
            if route == "q8q":
                def call(f):
                    return f(*case[:6], q_offset=case[6])

                plain = call(cuda_decode.paged_decode_q8q_plain)
            else:
                def call(f):
                    return f(*case[:4], q_offset=case[6],
                             block_scales=case[4:6])

                plain = call(cuda_decode.paged_decode_plain)
            teeth = {f: gate(q8q_paged_here(case, f, route), plain)
                     for f in (None, "logical", "v_early")}
            o, l = call(kernel)
            teeth["halved"] = gate((o * 0.5, l), plain)
            return teeth

        teeth = q8q_teeth(serve_q8, cuda_decode.attention_cuda_decode_paged_q8q)
        q8_teeth = {str(f): {"pass": r[0], "rel": r[2], "dlse": r[3]}
                    for f, r in teeth.items()}
        print(f"gate at B5's serve shape: written out here {teeth[None][2]:.3e} "
              f"relative (passes: {teeth[None][0]}); scales by logical block -> "
              f"{teeth['logical'][2]:.3e} relative, |dlse| "
              f"{teeth['logical'][3]:.3e}; V scalar before l -> "
              f"{teeth['v_early'][2]:.3e}, |dlse| {teeth['v_early'][3]:.3e}; "
              f"output halved -> {teeth['halved'][2]:.3e}", flush=True)
        if not teeth[None][0] or any(teeth[f][0] for f in
                                     ("logical", "v_early", "halved")):
            fail("the parity gate at B5's serve shape fails its own arithmetic "
                 "or accepts a planted fault")
        cast_teeth = q8q_teeth(serve_q8, b2t, route="q8")
        q8_teeth["cast tick"] = {str(f): {"pass": r[0], "rel": r[2], "dlse": r[3]}
                                 for f, r in cast_teeth.items()}
        print(f"gate at B2's cast tick: written out here {cast_teeth[None][2]:.3e}"
              f" relative (passes: {cast_teeth[None][0]}); scales by logical "
              f"block -> {cast_teeth['logical'][2]:.3e}; V scalar before l -> "
              f"{cast_teeth['v_early'][2]:.3e}; output halved -> "
              f"{cast_teeth['halved'][2]:.3e}", flush=True)
        if not cast_teeth[None][0] or any(cast_teeth[f][0] for f in
                                          ("logical", "v_early", "halved")):
            fail("the parity gate at B2's cast tick fails its own arithmetic "
                 "or accepts a planted fault")
        del serve_q8, kp8, vp8

        # The tick body (cuda_decode.decode_body "tick": B2, its cast route
        # and B5 at one packed row through a table) over D 64 and 128 and 64-
        # and 16-token blocks: 8 slots x 16 heads of at most 640 tokens on
        # disjoint tables, ragged, one slot with no visible key, one full, one
        # ending on a block edge. Every call counted on .tick_launches, gated
        # and timed beside its bound (bf16: and SDPA over the gathered view;
        # int8: SDPA over the dequantized view as the yardstick); the serve
        # shape's cases (D 128, block 64) are the head cases above. Bit for
        # bit: NaN in the keys past each slot's frontier inside its last block,
        # NaN blocks past each slot and in blocks no table names (bf16); codes
        # past each frontier changed and NaN scalars on blocks past each slot
        # and unnamed (int8) — all unread.
        tick_bits = {}
        for D in (128, 64):
            for tblk in (64, 16):
                tnb = 640 // tblk
                tn = 8 * tnb + 4  # the slots' blocks, and 4 no table names
                tk, tv = rnd(tn, 16, tblk, D), rnd(tn, 16, tblk, D)
                tkq, tvq = (torch.randint(-127, 128, (tn, 16, tblk, D),
                                          generator=g, device=dev,
                                          dtype=torch.int8) for _ in range(2))
                tbs = tuple(torch.rand((tn, 16), generator=g, device=dev) * 0.03
                            + 0.005 for _ in range(2))
                tcs = tuple(torch.rand((8, 16, 1, D), generator=g, device=dev)
                            * 0.03 + 0.005 for _ in range(2))
                ttab = torch.randperm(tn, generator=g, device=dev)[:8 * tnb] \
                    .reshape(8, tnb).to(torch.int32)
                tq = rnd(8, 16, 1, D)
                tqo = torch.randint(0, 639, (8,), generator=g, device=dev,
                                    dtype=torch.int32)
                tqo[0], tqo[1], tqo[2] = -1, 639, 3 * tblk - 1
                pairs = 16 * visible_pairs(tqo, 1, 640)
                tag = f"D{D} block{tblk} B8 H16 Tq1 ragged"
                cases_here = {
                    "bf16": (b2t, lambda k_, v_, s_: b2t(tq, k_, v_, ttab,
                                                         q_offset=tqo)),
                    "cast, per-block scales": (
                        b2t, lambda k_, v_, s_: b2t(tq, k_, v_, ttab,
                                                    q_offset=tqo,
                                                    block_scales=s_)),
                    "q8q, per-block scales": (
                        b5t, lambda k_, v_, s_: b5t(tq, k_, v_, ttab, *s_,
                                                    q_offset=tqo)),
                    "q8q, channel scales": (
                        b5t, lambda k_, v_, s_: b5t(tq, k_, v_, ttab, *tcs,
                                                    q_offset=tqo)),
                }
                plains = {
                    "bf16": lambda: cuda_decode.paged_decode_plain(
                        tq, tk, tv, ttab, q_offset=tqo),
                    "cast, per-block scales": lambda: cuda_decode
                    .paged_decode_plain(tq, tkq, tvq, ttab, q_offset=tqo,
                                        block_scales=tbs),
                    "q8q, per-block scales": lambda: cuda_decode
                    .paged_decode_q8q_plain(tq, tkq, tvq, ttab, *tbs,
                                            q_offset=tqo),
                    "q8q, channel scales": lambda: cuda_decode
                    .paged_decode_q8q_plain(tq, tkq, tvq, ttab, *tcs,
                                            q_offset=tqo),
                }
                mask = gqa_mask(tqo, 1, 640)
                kg, vg = gather_paged_kv(tk, tv, ttab)
                kgd, vgd = gather_paged_kv(deq(tkq, tbs[0][..., None, None]),
                                           deq(tvq, tbs[1][..., None, None]),
                                           ttab)
                # Past each slot: the rest of its last block, and its later
                # blocks; and the blocks no table names.
                past = torch.zeros((tn,), dtype=torch.bool, device=dev)
                unnamed = sorted(set(range(tn)) - set(ttab.flatten().tolist()))
                past[torch.tensor(unnamed, device=dev, dtype=torch.long)] = True
                tails = []
                for b_, o in enumerate(tqo.tolist()):
                    j1 = max(o + 1, 0)
                    for nb_ in range(-(-j1 // tblk), tnb):
                        past[ttab[b_, nb_].long()] = True
                    if j1 % tblk:
                        tails.append((int(ttab[b_, j1 // tblk]), j1 % tblk))
                for name, (wr, call) in cases_here.items():
                    int8 = name != "bf16"
                    kk, vv = (tkq, tvq) if int8 else (tk, tv)
                    fn = (lambda wr=wr, call=call, kk=kk, vv=vv:
                          ticked(wr, lambda: call(kk, vv, tbs)))
                    if D == 128 and tblk == 64:
                        # the serve shape: timed above; here the gate only
                        ok, eo, er, el = gate(fn(), plains[name]())
                        if not ok:
                            fail(f"tick {name} {tag}: |dout| {eo:.3e}, relative "
                                 f"{er:.3e}, |dlse| {el:.3e}")
                    else:
                        kernel = ("flash_decode_paged_q8q_tick"
                                  if name.startswith("q8q")
                                  else "flash_decode_paged_tick")
                        elem = 1 if int8 else 2
                        nbytes = (pairs * D * elem * 2 + tq.numel() * 4
                                  + (2 * 8 * tnb * 16 * 4 if "per-block" in name
                                     else 2 * tcs[0].numel() * 4 if int8 else 0))
                        record(kernel, f"{'int8 ' if int8 else ''}{tag}, {name}",
                               fn, plains[name],
                               None if int8 else (
                                   lambda: F.scaled_dot_product_attention(
                                       tq, kg, vg, attn_mask=mask)),
                               nbytes, 0.0 if int8 else 4.0 * D * pairs,
                               ops_s=(q8_ops_s(pairs, name.startswith("q8q"))
                                      * D / 128 if int8 else None),
                               yardstick=(lambda: F.scaled_dot_product_attention(
                                   tq, kgd, vgd, attn_mask=mask))
                               if int8 else None, names=own)
                    # Bit for bit: what lies past each slot is never read.
                    want = fn()
                    kk2, vv2 = kk.clone(), vv.clone()
                    if int8:
                        for pb_, r_ in tails:
                            kk2[pb_, :, r_:] = 127
                            vv2[pb_, :, r_:] = -127
                        kk2[past], vv2[past] = -127, 127
                        sc2 = tuple(x.clone() for x in tbs)
                        for x in sc2:
                            x[past] = math.nan
                    else:
                        for pb_, r_ in tails:
                            kk2[pb_, :, r_:] = math.nan
                            vv2[pb_, :, r_:] = math.nan
                        kk2[past], vv2[past] = math.nan, math.nan
                        sc2 = tbs
                    got = ticked(wr, lambda: call(kk2, vv2, sc2))
                    same = (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1]))
                    tick_bits[f"{tag}, {name}"] = same
                    if not same:
                        fail(f"tick {name} {tag}: what lies past each slot "
                             f"changed the result")
                del tk, tv, tkq, tvq, kg, vg, kgd, vgd
        print(f"tick body: {len(tick_bits)} sweep cases under the row gate, "
              f"past-the-frontier bytes unread bit for bit in every one: "
              f"{all(tick_bits.values())}", flush=True)

        # One long paged slot: the reference workload through a table (B1 H16,
        # 1000 blocks of 64 tokens), bf16 and B5 over its per-block-quantized
        # pool — the tick body's largest cluster.
        lk, lv = rnd(1000, 16, 64, 128), rnd(1000, 16, 64, 128)
        ltab = torch.randperm(1000, generator=g, device=dev)[None].to(torch.int32)
        lq = rnd(1, 16, 1, 128)
        lqo = torch.full((1,), 63999, dtype=torch.int32, device=dev)
        kg, vg = gather_paged_kv(lk, lv, ltab)
        record("flash_decode_paged_tick", "long slot B1 H16 block64 NB1000 Tq1",
               lambda: ticked(b2t, lambda: b2t(lq, lk, lv, ltab, q_offset=lqo)),
               lambda: cuda_decode.paged_decode_plain(lq, lk, lv, ltab,
                                                      q_offset=lqo),
               lambda: F.scaled_dot_product_attention(lq, kg, vg),
               2 * lk.numel() * 2 + 2 * lq.numel() * 2, 4.0 * 16 * 64000 * 128,
               names=own)
        del kg, vg
        lkq, lks = cuda_decode.quantize_symmetric_int8(lk.reshape(1000, 16, -1), 2)
        lvq, lvs = cuda_decode.quantize_symmetric_int8(lv.reshape(1000, 16, -1), 2)
        lkq, lvq = lkq.reshape(lk.shape), lvq.reshape(lv.shape)
        lks, lvs = lks[..., 0], lvs[..., 0]
        del lk, lv
        kgd, vgd = gather_paged_kv(deq(lkq, lks[..., None, None]),
                                   deq(lvq, lvs[..., None, None]), ltab)
        record("flash_decode_paged_q8q_tick", "int8 long slot B1 H16 block64 "
               "NB1000 Tq1, per-block scales",
               lambda: ticked(b5t, lambda: b5t(lq, lkq, lvq, ltab, lks, lvs,
                                               q_offset=lqo)),
               lambda: cuda_decode.paged_decode_q8q_plain(lq, lkq, lvq, ltab, lks,
                                                          lvs, q_offset=lqo),
               None, 2 * lkq.numel() + lq.numel() * 4 + 2 * 1000 * 16 * 4, 0.0,
               ops_s=q8_ops_s(16 * 64000, True),
               yardstick=lambda: F.scaled_dot_product_attention(lq, kgd, vgd),
               names=own)
        del lkq, lvq, kgd, vgd

        # The gate has teeth for the in-cluster merge: at the serve shape it
        # rejects the result with the last cluster rank's partial left out —
        # the plain version with that rank's units (cuda_decode.tick_units at
        # this launch's geometry) hidden.
        tgeo = cuda_decode.decode_geometry("tick", 1, 8, 16, nb * blk)
        cut = table.clone()
        for b_, o in enumerate(qoff.tolist()):
            for nb_, _, _ in cuda_decode.tick_units(tgeo, tgeo.ctas - 1, o, 1,
                                                    nb * blk, blk):
                cut[b_, nb_] = -1
        rank_out = gate(cuda_decode.paged_decode_plain(q, kp, vp, cut,
                                                       q_offset=qoff,
                                                       local_blocks=True),
                        cuda_decode.paged_decode_plain(q, kp, vp, table,
                                                       q_offset=qoff))
        tick_teeth = {"cluster": tgeo.ctas, "last_rank_left_out": {
            "pass": rank_out[0], "rel": rank_out[2], "dlse": rank_out[3]}}
        print(f"gate at the tick's serve shape (cluster of {tgeo.ctas}): the "
              f"last rank's partial left out -> relative |dout| "
              f"{rank_out[2]:.3e}, |dlse| {rank_out[3]:.3e}, rejected: "
              f"{not rank_out[0]}", flush=True)
        if rank_out[0] or tgeo.ctas < 2:
            fail("the parity gate accepts a cluster rank's partial left out")

        # -- 2b. B2 local_blocks: one rank's slice of a sequence-sharded pool --
        # The serve shapes (8 slots of 640 tokens in 64-token blocks, 16 heads
        # x 128; the tick Tq 1 and a 64-row chunk) over a pool of 80 blocks
        # sharded W = 2 and 4 ways, the table drawn as ShardedBlockAllocator
        # hands blocks out (richest shard first) to slots filled one after the
        # other, so each slot's blocks interleave over the ranks and every row
        # has keys on every rank. Each rank's call is held
        # against its plain version under the row gate, the W partials merged
        # by the in-process monoid against unsharded B2 on the whole pool;
        # exact bf16 and int8 with per-block scales. Timed: rank 0's call,
        # against its bound (the keys it holds up to each row's frontier, K+V,
        # plus Q, the scales it reads and the output / 3.35 TB/s).
        from tree_attention_tpu_torch.ops.reference import merge_partials
        from tree_attention_tpu_torch.serving import ShardedBlockAllocator

        b2 = cuda_decode.attention_cuda_decode_paged
        nb, blk, npool = 10, 64, 80
        pools = {"exact": (rnd(npool, 16, blk, 128), rnd(npool, 16, blk, 128),
                           None)}
        codes = [torch.randint(-127, 128, (npool, 16, blk, 128), generator=g,
                               device=dev, dtype=torch.int8) for _ in range(2)]
        scales = [torch.rand((npool, 16), generator=g, device=dev) * 0.03 + 0.005
                  for _ in range(2)]
        pools["int8"] = (codes[0], codes[1], tuple(scales))
        local_merge = {}
        local_unnamed = {}  # tick: the pool past each frontier unread

        def held_counts(loc, qoff, tq):
            """(keys a rank streams, (query, key) pairs it computes) under a
            signed local table: held keys up to each row's causal frontier."""
            held = (loc >= 0).repeat_interleave(blk, 1)          # (B, K)
            pos = torch.arange(nb * blk, device=dev)
            rows = qoff.long()[:, None] + torch.arange(tq, device=dev)
            vis = (pos[None, None] <= rows[..., None]) & held[:, None]
            keys = (held & (pos[None] <= rows[:, -1:])).sum().item()
            return keys, vis.sum().item()

        for W in (2, 4):
            alloc = ShardedBlockAllocator(npool, W)
            alloc.reserve(npool)
            # Slot by slot, as chunked prefill maps a prompt's blocks: each
            # slot's blocks alternate over the ranks.
            table = torch.tensor([[alloc.alloc() for _ in range(nb)]
                                  for _ in range(8)], dtype=torch.int32,
                                 device=dev)
            nl = npool // W
            for tq in (1, 64):
                q = rnd(8, 16, tq, 128)
                qoff = torch.randint(0, nb * blk - tq, (8,), generator=g,
                                     device=dev, dtype=torch.int32)
                for kind, (kf, vf, sf) in pools.items():
                    int8 = sf is not None
                    whole = b2(q, kf, vf, table, q_offset=qoff, block_scales=sf)
                    parts = []
                    for r in range(W):
                        kr, vr = kf[r * nl:(r + 1) * nl], vf[r * nl:(r + 1) * nl]
                        sr = None if sf is None else tuple(
                            x[r * nl:(r + 1) * nl] for x in sf)
                        loc = table - r * nl
                        loc = torch.where((loc >= 0) & (loc < nl), loc,
                                          -1).to(torch.int32)

                        def fn(kr=kr, vr=vr, loc=loc, sr=sr):
                            return b2(q, kr, vr, loc, q_offset=qoff,
                                      block_scales=sr, local_blocks=True,
                                      local_shards=W)

                        def plain(kr=kr, vr=vr, loc=loc, sr=sr):
                            return cuda_decode.paged_decode_plain(
                                q, kr, vr, loc, q_offset=qoff, block_scales=sr,
                                local_blocks=True)

                        name = (f"W{W} rank{r} {kind} B8 H16 block64 NB10 Tq{tq} "
                                f"ragged")
                        if r == 0:
                            keys, pairs = held_counts(loc, qoff, tq)
                            elem = 1 if int8 else 2
                            nbytes = (keys * 16 * 128 * elem * 2 + q.numel() * 4
                                      + (int((loc >= 0).sum()) * 16 * 8
                                         if int8 else 0))
                            kg, vg = gather_paged_kv(
                                deq(kr, sr[0][..., None, None]) if int8 else kr,
                                deq(vr, sr[1][..., None, None]) if int8 else vr,
                                loc)
                            held = (loc >= 0).repeat_interleave(blk, 1)
                            mask = gqa_mask(qoff, tq, nb * blk) & \
                                held[:, None, None, :]
                            sdpa = (lambda kg=kg, vg=vg, mask=mask:
                                    F.scaled_dot_product_attention(
                                        q, kg, vg, attn_mask=mask))
                            record("flash_decode_paged_local_tick" if tq == 1
                                   else "flash_decode_paged_local_tiled", name,
                                   fn, plain,
                                   None if int8 else sdpa, nbytes,
                                   0.0 if int8 else 4.0 * 128 * pairs * 16,
                                   ops_s=(q8_ops_s(16 * pairs, False) if int8
                                          else None),
                                   yardstick=sdpa if int8 else None,
                                   names=own)
                            del kg, vg, mask
                        else:
                            ok, eo, er, el = gate(fn(), plain())
                            if not ok:
                                fail(f"B2 local_blocks {name}: |dout| {eo:.3e}, "
                                     f"relative {er:.3e}, |dlse| {el:.3e}")
                        if tq == 1:
                            # A tick reads nothing of the rank's pool past each
                            # slot's frontier: the rest of the frontier block
                            # (NaN, bf16; other codes, int8) and every block no
                            # slot needs (NaN, or NaN scalars) change nothing,
                            # bit for bit.
                            need = torch.zeros(nl, dtype=torch.bool, device=dev)
                            tails = []
                            lrow = loc.tolist()
                            for b_, o in enumerate(qoff.tolist()):
                                for nb_, pb_ in enumerate(lrow[b_]):
                                    if pb_ >= 0 and nb_ * blk <= o:
                                        need[pb_] = True
                                        if o + 1 < (nb_ + 1) * blk:
                                            tails.append((pb_, o + 1 - nb_ * blk))
                            k2, v2 = kr.clone(), vr.clone()
                            s2 = sr
                            if int8:
                                s2 = tuple(x.clone() for x in sr)
                                for x in s2:
                                    x[~need] = math.nan
                                for pb_, r_ in tails:
                                    k2[pb_, :, r_:], v2[pb_, :, r_:] = 127, -127
                            else:
                                k2[~need], v2[~need] = math.nan, math.nan
                                for pb_, r_ in tails:
                                    k2[pb_, :, r_:] = math.nan
                                    v2[pb_, :, r_:] = math.nan
                            a_, b_ = fn(), b2(q, k2, v2, loc, q_offset=qoff,
                                              block_scales=s2, local_blocks=True,
                                              local_shards=W)
                            if not (torch.equal(a_[0], b_[0])
                                    and torch.equal(a_[1], b_[1])):
                                fail(f"B2 local_blocks tick {name}: bytes past "
                                     f"a slot's frontier were read")
                            local_unnamed[name] = True
                        parts.append(fn())
                    merged = merge_partials(torch.stack([o for o, _ in parts]),
                                            torch.stack([l for _, l in parts]))
                    ok, eo, er, el = gate(merged, whole)
                    local_merge[f"W{W} {kind} Tq{tq}"] = {
                        "pass": ok, "max_abs_err": eo, "max_rel_err": er,
                        "max_abs_err_lse": el}
                    print(f"B2 local_blocks W{W} {kind} Tq{tq}: {W} partials "
                          f"merged vs unsharded B2: |dout| {eo:.3e} relative "
                          f"{er:.3e} |dlse| {el:.3e}", flush=True)
                    if not ok:
                        fail(f"B2 local_blocks W{W} {kind} Tq{tq}: merged "
                             f"partials differ from unsharded B2")
        # A row whose every block another rank holds is exactly (0, -inf); and
        # the gate rejects a remote entry read as block 0 (the call without the
        # flag, remote entries clamped to 0: what an unguarded kernel reads).
        kf, vf, _ = pools["exact"]
        kr, vr = kf[:nl], vf[:nl]
        loc = torch.where((table >= 0) & (table < nl), table, -1).to(torch.int32)
        loc[3] = -1
        o, l = b2(q, kr, vr, loc, q_offset=qoff, local_blocks=True)
        identity = bool(torch.all(o[3] == 0) and torch.all(torch.isneginf(l[3])))
        # ... on the tick body too (one packed row).
        q1 = rnd(8, 16, 1, 128)
        o, l = ticked(b2, lambda: b2(q1, kr, vr, loc, q_offset=qoff,
                                     local_blocks=True))
        identity = identity and bool(torch.all(o[3] == 0)
                                     and torch.all(torch.isneginf(l[3])))
        read0 = gate(b2(q, kr, vr, loc.clamp(min=0), q_offset=qoff),
                     cuda_decode.paged_decode_plain(q, kr, vr, loc, q_offset=qoff,
                                                    local_blocks=True))
        local_teeth = {"all_remote_row_is_identity": identity,
                       "tick_past_frontier_unread": local_unnamed,
                       "remote_read_as_block0": {"pass": read0[0],
                                                 "rel": read0[2],
                                                 "dlse": read0[3]}}
        print(f"B2 local_blocks: all-remote row exactly (0, -inf) (the tick "
              f"and the 64-row chunk): {identity}; the rank's pool past each "
              f"frontier poisoned, unread bit for bit at the tick: "
              f"{len(local_unnamed)} calls; "
              f"remote entries read as block 0 -> relative |dout| "
              f"{read0[2]:.3e}, |dlse| {read0[3]:.3e}, rejected: "
              f"{not read0[0]}", flush=True)
        if not identity or read0[0]:
            fail("B2 local_blocks: an all-remote row is not (0, -inf), or the "
                 "gate accepts remote entries read as block 0")
        del pools, codes, scales, kf, vf, kr, vr, parts, merged, whole, o, l

        # -- 2c. per-shard tree_decode at the reference workload ---------------
        # B1 (H16, Tk 64000, Tq 1, bf16) over W = 2 and 4 KV shards, each with
        # its kv_offset, and B4 over the shards of the channel-quantized K/V
        # (scales of the whole sequence); the merged partials against the
        # unsharded B1 / B4 under the row gate.
        q = rnd(1, 16, 1, 128)
        k, v = rnd(1, 16, 64000, 128), rnd(1, 16, 64000, 128)
        kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(k, v)
        tree_merge = {}
        for kind, full, shard_fn in (
                ("B1", cuda_decode.attention_cuda_decode(q, k, v),
                 lambda lo, hi: cuda_decode.attention_cuda_decode(
                     q, k[:, :, lo:hi], v[:, :, lo:hi], kv_offset=lo)),
                ("B4", cuda_decode.attention_cuda_decode_q8q(q, kq, vq, ks, vs),
                 lambda lo, hi: cuda_decode.attention_cuda_decode_q8q(
                     q, kq[:, :, lo:hi], vq[:, :, lo:hi], ks, vs,
                     kv_offset=lo))):
            for W in (2, 4):
                step = 64000 // W
                parts = [shard_fn(r * step, (r + 1) * step) for r in range(W)]
                merged = merge_partials(torch.stack([o for o, _ in parts]),
                                        torch.stack([l for _, l in parts]))
                ok, eo, er, el = gate(merged, full)
                tree_merge[f"{kind} W{W}"] = {"pass": ok, "max_abs_err": eo,
                                              "max_rel_err": er,
                                              "max_abs_err_lse": el}
                print(f"tree_decode shards, reference workload, {kind} W{W}: "
                      f"merged vs unsharded |dout| {eo:.3e} relative {er:.3e} "
                      f"|dlse| {el:.3e}", flush=True)
                if not ok:
                    fail(f"tree_decode {kind} W{W}: merged shards differ from "
                         f"the unsharded kernel")
        del q, k, v, kq, vq, ks, vs, parts, merged

        # -- 2d. the tree variants of B1, B2, B4 and B5 -------------------------
        # Speculative tree verification: the tree mask replaces the causal rule
        # with the ancestor-window rule. Masks are random draft trees packed as
        # pack_proposal packs them (slot 1 a plain chain; at Tq 32 every slot's
        # last row sets bit 31). Shapes: B2/B5 at a verify tick (B8 H16, Tq 8
        # and 32, 640-token slots of 64-token blocks; bf16, int8 with per-block
        # scales), B1/B4 at the contiguous verify tick (B8 H16 Tk640) and at the
        # reference workload with Tq 8, and the int8-cast routes of B1 and B2.
        # Bound: the keys some row sees (history plus the window), K+V, plus Q
        # and the output / 3.35 TB/s, or the visible (row, key) pairs' products.
        # Library: SDPA with a boolean attn_mask over the gathered view (the
        # labelled yardstick for the int8 routes: over the dequantized view).
        from tree_attention_tpu_torch.ops.block_utils import tree_window_mask

        def tree_counts(trees, qoff, tk):
            """(keys some row sees, visible (row, key) pairs) over the slots:
            each row sees the history below the window and its ancestors."""
            tq = trees.shape[1]
            keys = sum(min(tk, int(o) + tq) for o in qoff.tolist())
            pairs = int(trees.sum()) + tq * int(qoff.clamp(max=tk).sum())
            return keys, pairs

        def tree_sdpa_mask(trees, qoff, tk):
            return tree_window_mask(trees, qoff, torch.zeros_like(qoff),
                                    tk)[:, None]  # (B, 1, Tq, Tk)

        tree_cases = {}
        causal_ms = {}  # the causal launch on the same inputs: the mask's cost
        blk, nb, npool = 64, 10, 96
        kp, vp = rnd(npool, 16, blk, 128), rnd(npool, 16, blk, 128)
        x = (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
             * torch.exp(0.7 * torch.randn((npool, 16, 1, 1), generator=g,
                                           device=dev)))
        kp8, kbs = cuda_decode.quantize_symmetric_int8(
            x.reshape(npool, 16, blk * 128), 2)
        x = (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
             * torch.exp(0.7 * torch.randn((npool, 16, 1, 1), generator=g,
                                           device=dev)))
        vp8, vbs = cuda_decode.quantize_symmetric_int8(
            x.reshape(npool, 16, blk * 128), 2)
        kp8, vp8 = (t.reshape(npool, 16, blk, 128) for t in (kp8, vp8))
        kbs, vbs = kbs[..., 0], vbs[..., 0]
        del x
        table = torch.stack([torch.randperm(npool, generator=g, device=dev)[:nb]
                             for _ in range(8)]).to(torch.int32)
        kgd, vgd = gather_paged_kv(deq(kp8, kbs[..., None, None]),
                                   deq(vp8, vbs[..., None, None]), table)
        kg, vg = gather_paged_kv(kp, vp, table)
        b2, b5 = (cuda_decode.attention_cuda_decode_paged,
                  cuda_decode.attention_cuda_decode_paged_q8q)
        for tq in TREE_TQS:
            q = rnd(8, 16, tq, 128)
            qoff = torch.randint(0, nb * blk - tq, (8,), generator=g, device=dev,
                                 dtype=torch.int32)
            qoff[0] = 3 * blk - 3  # the window straddles a block boundary
            trees = random_trees(8, tq, 1, tq).to(dev)
            keys, pairs = tree_counts(trees, qoff, nb * blk)
            mask = tree_sdpa_mask(trees, qoff, nb * blk)
            tree_cases[tq] = (q, qoff, trees)
            record("flash_decode_paged_tree", f"B8 H16 block64 NB10 Tq{tq} tree",
                   lambda: b2(q, kp, vp, table, q_offset=qoff, tree_mask=trees),
                   lambda: cuda_decode.paged_decode_plain(
                       q, kp, vp, table, q_offset=qoff, tree_mask=trees),
                   lambda: F.scaled_dot_product_attention(q, kg, vg,
                                                          attn_mask=mask),
                   keys * 16 * 128 * 2 * 2 + 2 * q.numel() * 2,
                   4.0 * 16 * 128 * pairs, names=own)
            record("flash_decode_paged_q8q_tree",
                   f"int8 B8 H16 block64 NB10 Tq{tq} tree, per-block scales",
                   lambda: b5(q, kp8, vp8, table, kbs, vbs, q_offset=qoff,
                              tree_mask=trees),
                   lambda: cuda_decode.paged_decode_q8q_plain(
                       q, kp8, vp8, table, kbs, vbs, q_offset=qoff,
                       tree_mask=trees),
                   None, keys * 16 * 128 * 2 + q.numel() * 4
                   + 2 * 8 * nb * 16 * 4, 0.0,
                   ops_s=q8_ops_s(16 * pairs, True),
                   yardstick=lambda: F.scaled_dot_product_attention(
                       q, kgd, vgd, attn_mask=mask), names=own)
            for name, fn in (
                    ("B2", lambda: b2(q, kp, vp, table, q_offset=qoff)),
                    ("B5", lambda: b5(q, kp8, vp8, table, kbs, vbs,
                                      q_offset=qoff))):
                causal_ms[f"{name} Tq{tq}"] = time_ms(
                    fn, keys * 16 * 128 * 2 / HBM_BYTES_PER_S * 1e3,
                    names=own)[0]
        print(f"the same inputs without the mask (causal launch) ms: "
              f"{json.dumps(causal_ms)}", flush=True)
        q, qoff, trees = tree_cases[8]
        keys, pairs = tree_counts(trees, qoff, nb * blk)
        mask = tree_sdpa_mask(trees, qoff, nb * blk)
        record("flash_decode_paged_tree",
               "int8 B8 H16 block64 NB10 Tq8 tree, block_scales",
               lambda: b2(q, kp8, vp8, table, q_offset=qoff,
                          block_scales=(kbs, vbs), tree_mask=trees),
               lambda: cuda_decode.paged_decode_plain(
                   q, kp8, vp8, table, q_offset=qoff, block_scales=(kbs, vbs),
                   tree_mask=trees),
               None, keys * 16 * 128 * 2 + q.numel() * 4 + 2 * 8 * nb * 16 * 4,
               0.0, ops_s=q8_ops_s(16 * pairs, False),
               yardstick=lambda: F.scaled_dot_product_attention(
                   q, kgd, vgd, attn_mask=mask), names=own)
        # Lower-triangular masks give the causal launches' out and lse bit for
        # bit (B2 and B5 here, B1 and B4 below); rows past a slot's window never
        # read a table entry past it: every entry past each slot's window names
        # a block of NaN (int8: NaN block scales), and the result is unchanged.
        tree_teeth = {}
        tril8 = torch.tril(torch.ones(8, 8, dtype=torch.bool, device=dev)
                           ).expand(8, 8, 8)
        for name, fn in (
                ("B2", lambda **kw: b2(q, kp, vp, table, q_offset=qoff, **kw)),
                ("B5", lambda **kw: b5(q, kp8, vp8, table, kbs, vbs,
                                       q_offset=qoff, **kw))):
            a, t = fn(), fn(tree_mask=tril8)
            tree_teeth[f"{name} tril == causal"] = (torch.equal(a[0], t[0])
                                                    and torch.equal(a[1], t[1]))
        q32, qoff32, trees32 = tree_cases[32]
        past = (torch.arange(nb, device=dev)[None] * blk
                >= (qoff32 + 32)[:, None])
        used = torch.zeros(npool, dtype=torch.bool, device=dev)
        used[table.long().flatten()] = True
        spare = int((~used).nonzero()[0])  # a block no slot maps
        nan_table = torch.where(past, spare, table).to(torch.int32)
        kn, vn = kp.clone(), vp.clone()
        kn[spare], vn[spare] = math.nan, math.nan
        ksn, vsn = kbs.clone(), vbs.clone()
        ksn[spare], vsn[spare] = math.nan, math.nan
        if not bool(past.any()):
            fail("tree: no table entry lies past a window")
        for name, a, t in (
                ("B2", b2(q32, kp, vp, table, q_offset=qoff32, tree_mask=trees32),
                 b2(q32, kn, vn, nan_table, q_offset=qoff32, tree_mask=trees32)),
                ("B5", b5(q32, kp8, vp8, table, kbs, vbs, q_offset=qoff32,
                          tree_mask=trees32),
                 b5(q32, kp8, vp8, nan_table, ksn, vsn, q_offset=qoff32,
                    tree_mask=trees32))):
            tree_teeth[f"{name} entries past the window unread"] = (
                torch.equal(a[0], t[0]) and torch.equal(a[1], t[1]))
        del kn, vn
        # The gate has teeth for the window rule: it rejects each row reading
        # the previous row's bits, and the window shifted by one key.
        got = b2(q32, kp, vp, table, q_offset=qoff32, tree_mask=trees32)
        for fault, plain in (
                ("previous row's bits", cuda_decode.paged_decode_plain(
                    q32, kp, vp, table, q_offset=qoff32,
                    tree_mask=trees32.roll(1, 1))),
                ("window shifted by one key", cuda_decode.paged_decode_plain(
                    q32, kp, vp, table, q_offset=qoff32 + 1,
                    tree_mask=trees32))):
            r = gate(got, plain)
            tree_teeth[fault] = {"pass": r[0], "rel": r[2], "dlse": r[3]}
        print(f"tree variants: {json.dumps(tree_teeth)}", flush=True)
        if not all(tree_teeth[k] for k in tree_teeth if "==" in k or "unread"
                   in k) or any(tree_teeth[f]["pass"] for f in (
                       "previous row's bits", "window shifted by one key")):
            fail(f"tree variants: {tree_teeth}")
        del kp, vp, kp8, vp8, kg, vg, kgd, vgd, got
        # B1 and B4 at the contiguous verify tick (8 slots of 640 tokens) and at
        # the reference workload with Tq 8; the int8-cast route of B1.
        b1, b4 = (cuda_decode.attention_cuda_decode,
                  cuda_decode.attention_cuda_decode_q8q)
        for shape, B, tk in (("B8 H16 Tk640", 8, 640),
                             ("ref B1 H16 Tk64000", 1, 64000)):
            q, k, v = rnd(B, 16, 8, 128), rnd(B, 16, tk, 128), rnd(B, 16, tk, 128)
            qoff = (torch.randint(0, tk - 8, (B,), generator=g, device=dev,
                                  dtype=torch.int32) if B > 1 else
                    torch.full((1,), tk - 8, dtype=torch.int32, device=dev))
            trees = random_trees(B, 8, 1 if B > 1 else -1, 3).to(dev)
            keys, pairs = tree_counts(trees, qoff, tk)
            mask = tree_sdpa_mask(trees, qoff, tk)
            kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(k, v)
            kd, vd = deq(kq, ks), deq(vq, vs)
            kw = dict(causal=True, q_offset=qoff)
            record("flash_decode_tree", f"{shape} Tq8 tree",
                   lambda: b1(q, k, v, tree_mask=trees, **kw),
                   lambda: cuda_decode.decode_plain(q, k, v, tree_mask=trees,
                                                    **kw),
                   lambda: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=mask),
                   keys * 16 * 128 * 2 * 2 + 2 * q.numel() * 2,
                   4.0 * 16 * 128 * pairs, names=own)
            q8_bytes = keys * 16 * 128 * 2 + q.numel() * 4 + 4 * ks.numel() * 4
            record("flash_decode_q8q_tree", f"int8 {shape} Tq8 tree",
                   lambda: b4(q, kq, vq, ks, vs, tree_mask=trees, **kw),
                   lambda: cuda_decode.decode_q8q_plain(
                       q, kq, vq, ks, vs, tree_mask=trees, **kw),
                   None, q8_bytes, 0.0, ops_s=q8_ops_s(16 * pairs, True),
                   yardstick=lambda: F.scaled_dot_product_attention(
                       q, kd, vd, attn_mask=mask), names=own)
            if B == 1:
                record("flash_decode_tree", f"int8 {shape} Tq8 tree, cast",
                       lambda: cuda_decode.attention_cuda_decode_q8(
                           q, kq, vq, ks, vs, tree_mask=trees, **kw),
                       lambda: cuda_decode.decode_q8_plain(
                           q, kq, vq, ks, vs, tree_mask=trees, **kw),
                       None, q8_bytes, 0.0, ops_s=q8_ops_s(16 * pairs, False),
                       yardstick=lambda: F.scaled_dot_product_attention(
                           q, kd, vd, attn_mask=mask), names=own)
            tril = torch.tril(torch.ones(8, 8, dtype=torch.bool, device=dev)
                              ).expand(B, 8, 8)
            for name, fn in (("B1", lambda **a: b1(q, k, v, **kw, **a)),
                             ("B4", lambda **a: b4(q, kq, vq, ks, vs, **kw,
                                                   **a))):
                a, t = fn(), fn(tree_mask=tril)
                same = torch.equal(a[0], t[0]) and torch.equal(a[1], t[1])
                tree_teeth[f"{name} {shape} tril == causal"] = same
                if not same:
                    fail(f"tree: {name} {shape} with a lower-triangular mask "
                         f"differs from the causal launch")
            del q, k, v, kq, vq, kd, vd, mask
        torch.cuda.empty_cache()

        # -- 2e. B2's multi-row body: bf16, more than one packed row ----------
        # The body the plain serve's prompt tails (chunk buckets Tq 8-64, below
        # the Q-tile width), the verify ticks (2d) and the sharded pool's chunks
        # (2b) run, by cuda_decode.decode_body's rule. Row gate against the
        # plain version at Tq 2, 8, 28, 32, 64, 127 for G 1 (H16) and 4 (Hq64
        # Hkv16) over 640-token slots of 64-token blocks, ragged: one slot's
        # window ends on a block's last key, one starts on a block's first;
        # every table entry past each slot's window names a block of NaN (never
        # read). Then local_blocks (W 2, rank 0) with the rank's slice holding
        # NaN in block 0 and in every block its table does not name: a remote
        # entry read as block 0 would poison its row. Each launch must count on
        # .tiled_launches. Timed: the prompt-tail buckets, the 64-row chunk
        # first, beside SDPA with the causal mask over the gathered view.
        tiled_gate = {}
        b2 = cuda_decode.attention_cuda_decode_paged
        blk, nb, npool = 64, 10, 96
        kp, vp = rnd(npool, 16, blk, 128), rnd(npool, 16, blk, 128)
        table = torch.stack([torch.randperm(npool, generator=g, device=dev)[:nb]
                             for _ in range(8)]).to(torch.int32)
        used = torch.zeros(npool, dtype=torch.bool, device=dev)
        used[table.long().flatten()] = True
        spare = int((~used).nonzero()[0])
        kn, vn = kp.clone(), vp.clone()
        kn[spare], vn[spare] = math.nan, math.nan

        def tiled_call(fn):
            before = b2.tiled_launches
            out = fn()
            if b2.tiled_launches != before + 1:
                fail("B2's multi-row body did not take a bf16 multi-row launch")
            return out

        def ragged_qoff(tq):
            qoff = torch.randint(0, nb * blk - tq, (8,), generator=g, device=dev,
                                 dtype=torch.int32)
            qoff[0] = 3 * blk - tq  # the window ends on a block's last key
            qoff[1] = 5 * blk       # ... starts on a block's first key
            return qoff

        for G in (1, 4):
            for tq in (2, 8, 28, 32, 64, 127):
                q = rnd(8, 16 * G, tq, 128)
                qoff = ragged_qoff(tq)
                past = (torch.arange(nb, device=dev)[None] * blk
                        >= (qoff + tq)[:, None])
                nan_table = torch.where(past, spare, table).to(torch.int32)
                got = tiled_call(lambda: b2(q, kn, vn, nan_table, q_offset=qoff))
                ok, eo, er, el = gate(got, cuda_decode.paged_decode_plain(
                    q, kp, vp, table, q_offset=qoff))
                tiled_gate[f"G{G} Tq{tq}"] = {"pass": ok, "max_abs_err": eo,
                                              "max_rel_err": er,
                                              "max_abs_err_lse": el}
                if not ok:
                    fail(f"B2 multi-row G{G} Tq{tq} (entries past each window "
                         f"NaN): |dout| {eo:.3e}, relative {er:.3e}, |dlse| "
                         f"{el:.3e}")
        from tree_attention_tpu_torch.serving import ShardedBlockAllocator

        alloc = ShardedBlockAllocator(80, 2)
        alloc.reserve(80)
        gtable = torch.tensor([[alloc.alloc() for _ in range(nb)]
                               for _ in range(8)], dtype=torch.int32, device=dev)
        kr, vr = kp[:40], vp[:40]  # rank 0's slice: global ids [0, 40)
        loc = torch.where(gtable < 40, gtable, -1).to(torch.int32)
        nan_blocks = torch.full((9, 16, blk, 128), math.nan, device=dev,
                                dtype=torch.bfloat16)
        kpois = torch.cat([nan_blocks[:1], kr, nan_blocks[1:]])
        vpois = torch.cat([nan_blocks[:1], vr, nan_blocks[1:]])
        for tq in (8, 64):
            q = rnd(8, 16, tq, 128)
            qoff = ragged_qoff(tq)
            past = (torch.arange(nb, device=dev)[None] * blk
                    >= (qoff + tq)[:, None])
            # Held entries shift by the NaN block 0; past each window they name
            # it (held, never read); remote entries stay -1.
            lpois = torch.where(loc >= 0, torch.where(past, 0, loc + 1),
                                -1).to(torch.int32)
            got = tiled_call(lambda: b2(q, kpois, vpois, lpois, q_offset=qoff,
                                        local_blocks=True, local_shards=2))
            ok, eo, er, el = gate(got, cuda_decode.paged_decode_plain(
                q, kr, vr, loc, q_offset=qoff, local_blocks=True))
            tiled_gate[f"local W2 rank0 Tq{tq}"] = {
                "pass": ok, "max_abs_err": eo, "max_rel_err": er,
                "max_abs_err_lse": el}
            if not ok:
                fail(f"B2 multi-row local_blocks Tq{tq} (unnamed blocks NaN): "
                     f"|dout| {eo:.3e}, relative {er:.3e}, |dlse| {el:.3e}")
        print(f"B2 multi-row body, row gate (entries past each window and "
              f"unnamed local blocks NaN): worst relative "
              f"{max(c['max_rel_err'] for c in tiled_gate.values()):.3e}, |dlse| "
              f"{max(c['max_abs_err_lse'] for c in tiled_gate.values()):.3e}, "
              f"{len(tiled_gate)} cases pass", flush=True)
        del kn, vn, kpois, vpois, nan_blocks, kr, vr
        kg, vg = gather_paged_kv(kp, vp, table)
        for tq in (64, 8, 16, 32):
            q = rnd(8, 16, tq, 128)
            qoff = ragged_qoff(tq)
            need = sum(min(nb * blk, int(o) + tq) for o in qoff.tolist())
            mask = gqa_mask(qoff, tq, nb * blk)
            record("flash_decode_paged_tiled",
                   f"{'chunk' if tq == 64 else 'prompt tail'} B8 H16 block64 "
                   f"NB10 Tq{tq} ragged",
                   lambda: b2(q, kp, vp, table, q_offset=qoff),
                   lambda: cuda_decode.paged_decode_plain(q, kp, vp, table,
                                                          q_offset=qoff),
                   lambda: F.scaled_dot_product_attention(q, kg, vg,
                                                          attn_mask=mask),
                   need * 16 * 128 * 2 * 2 + 2 * q.numel() * 2,
                   4.0 * 16 * 128 * visible_pairs(qoff, tq, nb * blk),
                   names=own)
        del kp, vp, kg, vg, mask

        # -- 2f. B1 and B5 on the multi-row body --------------------------------
        # B1 (contiguous bf16) and B5 (paged int8 x int8) with more than one
        # packed row take the multi-row body (cuda_decode.decode_body), as B2
        # does: every such launch must count on the wrapper's .tiled_launches.
        # B1 under the row gate at GQA Tq 16 over Tk 4096 and 4037, Tq 2, 5, 64,
        # 127 at G 1 and 4, D 64 and 128, causal with per-slot kv_offset (a
        # tree_decode shard; slot 2's shard lies wholly past its frontier and
        # must come back exactly (0, -inf)) and not causal; K/V rows past each
        # slot's frontier set to NaN change nothing, bit for bit; the gate
        # rejects an output halved and one split's keys left out. (The tree
        # ticks, tril == causal included, are phase 2d's.) B5 at the verify
        # ticks (B8 H16 640-token slots, Tq 8 and 32, chain and tree) over
        # 64- and 16-token blocks whose magnitudes, and so per-block scales,
        # differ by block, and with channel scales; codes at +-127 at D 128;
        # tril == causal and NaN blocks and NaN scales past each window change
        # nothing, bit for bit; the gate rejects scales read by logical block,
        # the V scalar applied before the softmax sum and an output halved.
        # Timed: B5's chain verify ticks (its tree ticks are phase 2d's).
        b1 = cuda_decode.attention_cuda_decode
        b5 = cuda_decode.attention_cuda_decode_paged_q8q
        multi_gate = {}

        def multi_call(w, fn, cast=False):
            """``fn()``, which must launch ``w``'s multi-row body once (with
            ``cast``, its int8 cast route: counted on .cast_tiled_launches
            too, and only then)."""
            def counts():
                return (w.tiled_launches, getattr(w, "cast_tiled_launches", 0))

            before = counts()
            out = fn()
            if counts() != (before[0] + 1, before[1] + int(cast)):
                fail(f"{w.__name__}: a multi-row launch did not take the "
                     f"multi-row body")
            return out

        def multi_check(name, got, want, store=multi_gate):
            ok, eo, er, el = gate(got, want)
            store[name] = {"pass": ok, "max_abs_err": eo, "max_rel_err": er,
                           "max_abs_err_lse": el}
            if not ok:
                fail(f"multi-row {name}: |dout| {eo:.3e}, relative {er:.3e}, "
                     f"|dlse| {el:.3e}")

        def same(a, b):
            return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

        multi_bits = {}
        for D in (64, 128):
            for G, tq, tk in ((4, 16, 4096), (4, 16, 4037), (1, 2, 640),
                              (4, 5, 640), (1, 64, 700), (4, 127, 700)):
                q = rnd(4, 8 * G, tq, D)
                k, v = rnd(4, 8, tk, D), rnd(4, 8, tk, D)
                qo = torch.tensor([tk - tq, 500, tk - 1, 60], dtype=torch.int32,
                                  device=dev)
                ko = torch.tensor([0, 37, tk + 200, 5], dtype=torch.int32,
                                  device=dev)
                kw = dict(causal=True, q_offset=qo, kv_offset=ko)
                name = f"B1 D{D} G{G} Tq{tq} Tk{tk}"
                got = multi_call(b1, lambda: b1(q, k, v, **kw))
                multi_check(name + " causal", got,
                            cuda_decode.decode_plain(q, k, v, **kw))
                if not (torch.all(got[0][2] == 0)
                        and torch.all(torch.isneginf(got[1][2]))):
                    fail(f"{name}: the shard past its frontier is not (0, -inf)")
                multi_check(name + " not causal",
                            multi_call(b1, lambda: b1(q, k, v)),
                            cuda_decode.decode_plain(q, k, v))
                kn, vn = k.clone(), v.clone()
                for b in range(4):
                    lo = max(0, int(qo[b] - ko[b]) + tq)
                    kn[b, :, lo:], vn[b, :, lo:] = math.nan, math.nan
                multi_bits[f"{name} NaN past each frontier unread"] = same(
                    got, b1(q, kn, vn, **kw))
                del kn, vn
        # The gate has teeth at B1's multi-row shape (the last one above, GQA
        # Tq 16 is the first: redo it): an output halved, the first split's
        # keys left out.
        q, k, v = rnd(8, 32, 16, 128), rnd(8, 8, 4096, 128), rnd(8, 8, 4096, 128)
        qo = torch.randint(1024, 4096 - 16, (8,), generator=g, device=dev,
                           dtype=torch.int32)
        plain = cuda_decode.decode_plain(q, k, v, causal=True, q_offset=qo)
        o, l = b1(q, k, v, causal=True, q_offset=qo)
        cut = cuda_decode.decode_geometry("tiled", 64, 8, 8, 4096).split_len
        half = gate((o * 0.5, l), plain)
        dropped = gate(cuda_decode.decode_plain(
            q, k[:, :, cut:], v[:, :, cut:], causal=True, q_offset=qo,
            kv_offset=cut), plain)
        multi_teeth = {"B1 output halved": {"pass": half[0], "rel": half[2]},
                       f"B1 first split ({cut} keys) left out": {
                           "pass": dropped[0], "dlse": dropped[3]}}
        del q, k, v, plain, o, l
        for blk in (64, 16):
            nb = 640 // blk
            npool = 12 * nb  # the 8 slots' tables leave blocks no slot maps
            codes_scales = []
            for _ in range(2):  # K, V: magnitudes that differ by block
                x = (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
                     * torch.exp(0.7 * torch.randn((npool, 16, 1, 1),
                                                   generator=g, device=dev)))
                c8, sc = cuda_decode.quantize_symmetric_int8(
                    x.reshape(npool, 16, blk * 128), 2)
                codes_scales.append((c8.reshape(npool, 16, blk, 128), sc[..., 0]))
            (kp8, kbs), (vp8, vbs) = codes_scales
            cks, cvs = (torch.rand((8, 16, 1, 128), generator=g, device=dev)
                        * 0.03 + 0.005 for _ in range(2))
            table = torch.stack([torch.randperm(npool, generator=g,
                                                device=dev)[:nb]
                                 for _ in range(8)]).to(torch.int32)
            used = torch.zeros(npool, dtype=torch.bool, device=dev)
            used[table.long().flatten()] = True
            spare = int((~used).nonzero()[0])
            ksn, vsn = kbs.clone(), vbs.clone()
            ksn[spare], vsn[spare] = math.nan, math.nan
            for tq in (8, 32):
                q = rnd(8, 16, tq, 128)
                qo = torch.randint(0, 640 - tq, (8,), generator=g, device=dev,
                                   dtype=torch.int32)
                qo[0] = 3 * blk - 3  # the window straddles a block boundary
                trees = random_trees(8, tq, 1, tq + blk).to(dev)
                tril = torch.tril(torch.ones(tq, tq, dtype=torch.bool,
                                             device=dev)).expand(8, tq, tq)
                past = (torch.arange(nb, device=dev)[None] * blk
                        >= (qo + tq)[:, None])
                nan_table = torch.where(past, spare, table).to(torch.int32)
                for tm, kind in ((None, "chain"), (trees, "tree")):
                    for sk, (ks_, vs_) in (("per-block", (kbs, vbs)),
                                           ("channel", (cks, cvs))):
                        name = f"B5 block{blk} Tq{tq} {kind} {sk}"
                        got = multi_call(b5, lambda: b5(
                            q, kp8, vp8, table, ks_, vs_, q_offset=qo,
                            tree_mask=tm))
                        multi_check(name, got, cuda_decode.paged_decode_q8q_plain(
                            q, kp8, vp8, table, ks_, vs_, q_offset=qo,
                            tree_mask=tm))
                        if sk == "per-block":
                            multi_bits[f"{name}: NaN blocks and scales past the "
                                       f"window unread"] = same(got, b5(
                                           q, kp8, vp8, nan_table, ksn, vsn,
                                           q_offset=qo, tree_mask=tm))
                multi_bits[f"B5 block{blk} Tq{tq} tril == causal"] = same(
                    b5(q, kp8, vp8, table, kbs, vbs, q_offset=qo),
                    b5(q, kp8, vp8, table, kbs, vbs, q_offset=qo,
                       tree_mask=tril))
                if blk == 16 and tq == 8:
                    # The gate's teeth at B5's multi-row shape, several blocks
                    # (and so scalars) in each 64-key tile.
                    teeth = q8q_teeth((q, kp8, vp8, table, kbs, vbs, qo), b5)
                    multi_teeth.update({f"B5 {f}": {"pass": r[0], "rel": r[2],
                                                    "dlse": r[3]}
                                        for f, r in teeth.items()})
                if blk == 64:
                    keys = sum(min(nb * blk, int(o) + tq) for o in qo.tolist())
                    pairs = visible_pairs(qo, tq, nb * blk)
                    mask = gqa_mask(qo, tq, nb * blk)
                    kgd, vgd = gather_paged_kv(deq(kp8, kbs[..., None, None]),
                                               deq(vp8, vbs[..., None, None]),
                                               table)
                    record("flash_decode_paged_q8q_tiled",
                           f"int8 B8 H16 block64 NB10 Tq{tq} chain, per-block "
                           f"scales",
                           lambda: b5(q, kp8, vp8, table, kbs, vbs, q_offset=qo),
                           lambda: cuda_decode.paged_decode_q8q_plain(
                               q, kp8, vp8, table, kbs, vbs, q_offset=qo),
                           None, keys * 16 * 128 * 2 + q.numel() * 4
                           + 2 * 8 * nb * 16 * 4, 0.0,
                           ops_s=q8_ops_s(16 * pairs, True),
                           yardstick=lambda: F.scaled_dot_product_attention(
                               q, kgd, vgd, attn_mask=mask), names=own,
                           parts=("decode_tiled", "merge_splits"))
                    del kgd, vgd, mask
        # Saturated codes: every Q code (each row +-1 before the fold, so
        # absmax/127 puts every code at +-127) and every K code at +-127.
        kp8 = (torch.randint(0, 2, (40, 16, 64, 128), generator=g, device=dev,
                             dtype=torch.int8) * 2 - 1) * 127
        vp8 = torch.randint(-127, 128, (40, 16, 64, 128), generator=g,
                            device=dev, dtype=torch.int8)
        kbs, vbs = (torch.rand((40, 16), generator=g, device=dev) * 0.03 + 0.005
                    for _ in range(2))
        table = torch.stack([torch.randperm(40, generator=g, device=dev)[:10]
                             for _ in range(8)]).to(torch.int32)
        q = (torch.randint(0, 2, (8, 16, 8, 128), generator=g, device=dev) * 2
             - 1).to(torch.bfloat16)
        qo = torch.randint(0, 632, (8,), generator=g, device=dev,
                           dtype=torch.int32)
        codes, _ = cuda_decode._fold_quantize_q(q, 16, None, None)
        if not bool((codes.abs() == 127).all()):
            fail("saturated case: Q codes are not all +-127")
        multi_check("B5 saturated codes D128 Tq8",
                    multi_call(b5, lambda: b5(q, kp8, vp8, table, kbs, vbs,
                                              q_offset=qo)),
                    cuda_decode.paged_decode_q8q_plain(q, kp8, vp8, table, kbs,
                                                       vbs, q_offset=qo))
        print(f"multi-row B1 and B5, row gate: {len(multi_gate)} cases pass, "
              f"worst relative "
              f"{max(c['max_rel_err'] for c in multi_gate.values()):.3e}, "
              f"|dlse| "
              f"{max(c['max_abs_err_lse'] for c in multi_gate.values()):.3e}; "
              f"bit for bit {json.dumps(multi_bits)}; the gate's teeth "
              f"{json.dumps(multi_teeth)}", flush=True)
        if not all(multi_bits.values()):
            fail(f"multi-row B1/B5 bit-for-bit checks: {multi_bits}")
        if not multi_teeth["B5 None"]["pass"] or any(
                r["pass"] for f, r in multi_teeth.items() if f != "B5 None"):
            fail(f"multi-row B1/B5: the gate fails its own arithmetic or "
                 f"accepts a planted fault: {multi_teeth}")
        del kp8, vp8, q, codes
        torch.cuda.empty_cache()

        # -- 2g. B4 and the int8 cast route on the multi-row body ---------------
        # B4 (contiguous q8q) and the cast route over B1/B2 (bf16 Q against
        # int8 K/V) with more than one packed row or a tree take the multi-row
        # body (cuda_decode.decode_body): every such launch must count on B4's
        # .tiled_launches, or on B1's / B2's .cast_tiled_launches. Under the
        # row gate: B4 and the contiguous cast route at B1's phase-2f shapes
        # (GQA Tq 16 over Tk 4096 and 4037, Tq 2, 5, 64, 127, G 1 and 4, D 64
        # and 128, causal with per-slot kv_offset — slot 2's shard lies wholly
        # past its frontier and must come back exactly (0, -inf) — and not),
        # trees at Tq 8 and 32 over 640-token slots, B4 at the reference
        # workload with a Tq-8 tree; the paged cast route at Tq 8, 32, 64 over
        # 64- and 16-token blocks with per-block scales that differ by block
        # and with channel scales, trees at Tq 8 and 32, and the local_blocks
        # 64-row chunk at W 2 and 4, its ranks' partials merged against
        # unsharded B2; codes at +-127. Bit for bit: tril == causal; int8
        # codes past each frontier changed (int8 has no NaN: codes not read
        # cannot matter); table entries past each window naming a block whose
        # per-block scalars are NaN, and under local_blocks NaN scalars in
        # block 0 and every block the rank's table does not name (a scalar
        # read there poisons its row through p * vs). The gate rejects an
        # output halved, one split's keys left out, scalars read by logical
        # block and the V scalar applied before the softmax sum (the cast
        # route's arithmetic written out here passes it). Timed, beside the
        # bound and the dequantized-SDPA yardstick: B4 at the contiguous chain
        # verify tick and GQA Tq 16, the cast route at the contiguous tree tick
        # and GQA Tq 16 and at the paged chain tick and 64-row chunk (their
        # other trees are phase 2d's, the local chunk phase 2b's).
        b1 = cuda_decode.attention_cuda_decode
        b2 = cuda_decode.attention_cuda_decode_paged
        b4 = cuda_decode.attention_cuda_decode_q8q
        q8_route = cuda_decode.resolve_q8_kernel
        int8_gate, int8_bits, int8_teeth = {}, {}, {}

        def int8_call(w, fn):
            return multi_call(w, fn, cast=w is not b4)

        def int8_check(name, got, want):
            multi_check(name, got, want, store=int8_gate)

        routes = (("B4", "q8q", b4), ("B1 cast", "q8", b1))
        for D in (64, 128):
            for G, tq, tk in ((4, 16, 4096), (4, 16, 4037), (1, 2, 640),
                              (4, 5, 640), (1, 64, 700), (4, 127, 700)):
                q = rnd(4, 8 * G, tq, D)
                kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
                    rnd(4, 8, tk, D), rnd(4, 8, tk, D))
                qo = torch.tensor([tk - tq, 500, tk - 1, 60], dtype=torch.int32,
                                  device=dev)
                ko = torch.tensor([0, 37, tk + 200, 5], dtype=torch.int32,
                                  device=dev)
                kw = dict(causal=True, q_offset=qo, kv_offset=ko)
                kn, vn = kq.clone(), vq.clone()
                for b in range(4):  # other codes past each slot's frontier
                    lo = max(0, int(qo[b] - ko[b]) + tq)
                    kn[b, :, lo:], vn[b, :, lo:] = 127, -127
                for kind, route, w in routes:
                    fn, plain = q8_route(route), q8_route(route, plain=True)
                    name = f"{kind} D{D} G{G} Tq{tq} Tk{tk}"
                    got = int8_call(w, lambda: fn(q, kq, vq, ks, vs, **kw))
                    int8_check(name + " causal", got,
                               plain(q, kq, vq, ks, vs, **kw))
                    if not (torch.all(got[0][2] == 0)
                            and torch.all(torch.isneginf(got[1][2]))):
                        fail(f"{name}: the shard past its frontier is not "
                             f"(0, -inf)")
                    int8_check(name + " not causal",
                               int8_call(w, lambda: fn(q, kq, vq, ks, vs)),
                               plain(q, kq, vq, ks, vs))
                    int8_bits[f"{name}: codes past each frontier unread"] = \
                        same(got, fn(q, kn, vn, ks, vs, **kw))
                del kn, vn
        # Trees (and chains) at the contiguous verify tick: 8 slots of 640.
        for tq in TREE_TQS:
            q = rnd(8, 16, tq, 128)
            kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
                rnd(8, 16, 640, 128), rnd(8, 16, 640, 128))
            qo = torch.randint(0, 640 - tq, (8,), generator=g, device=dev,
                               dtype=torch.int32)
            trees = random_trees(8, tq, 1, tq + 5).to(dev)
            tril = torch.tril(torch.ones(tq, tq, dtype=torch.bool,
                                         device=dev)).expand(8, tq, tq)
            kw = dict(causal=True, q_offset=qo)
            for kind, route, w in routes:
                fn, plain = q8_route(route), q8_route(route, plain=True)
                name = f"{kind} B8 H16 Tk640 Tq{tq}"
                got = int8_call(w, lambda: fn(q, kq, vq, ks, vs, tree_mask=trees,
                                              **kw))
                int8_check(name + " tree", got,
                           plain(q, kq, vq, ks, vs, tree_mask=trees, **kw))
                int8_bits[f"{name} tril == causal"] = same(
                    int8_call(w, lambda: fn(q, kq, vq, ks, vs, **kw)),
                    fn(q, kq, vq, ks, vs, tree_mask=tril, **kw))
        # B4 at the reference workload with a Tq-8 tree (timed in phase 2d).
        q = rnd(1, 16, 8, 128)
        kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
            rnd(1, 16, 64000, 128), rnd(1, 16, 64000, 128))
        kw = dict(causal=True, tree_mask=random_trees(1, 8, -1, 4).to(dev),
                  q_offset=torch.full((1,), 64000 - 8, dtype=torch.int32,
                                      device=dev))
        int8_check("B4 ref B1 H16 Tk64000 Tq8 tree",
                   int8_call(b4, lambda: b4(q, kq, vq, ks, vs, **kw)),
                   cuda_decode.decode_q8q_plain(q, kq, vq, ks, vs, **kw))
        del kq, vq
        # The gate's teeth at GQA Tq 16 (B4 and the contiguous cast route): an
        # output halved, the first split's keys left out.
        q = rnd(8, 32, 16, 128)
        kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
            rnd(8, 8, 4096, 128), rnd(8, 8, 4096, 128))
        qo = torch.randint(1024, 4096 - 16, (8,), generator=g, device=dev,
                           dtype=torch.int32)
        cut = cuda_decode.decode_geometry("tiled", 64, 8, 8, 4096).split_len
        for kind, route, w in routes:
            kw = dict(causal=True, q_offset=qo)
            plain = q8_route(route, plain=True)(q, kq, vq, ks, vs, **kw)
            o, l = q8_route(route)(q, kq, vq, ks, vs, **kw)
            half = gate((o * 0.5, l), plain)
            dropped = gate(q8_route(route, plain=True)(
                q, kq[:, :, cut:], vq[:, :, cut:], ks, vs, kv_offset=cut, **kw),
                plain)
            int8_teeth[f"{kind} output halved"] = {"pass": half[0],
                                                   "rel": half[2]}
            int8_teeth[f"{kind} first split ({cut} keys) left out"] = {
                "pass": dropped[0], "dlse": dropped[3]}
        del q, kq, vq, o, l, plain
        # The paged cast route: per-block scales (magnitudes that differ by
        # block) and channel scales, over 64- and 16-token blocks.
        for blk in (64, 16):
            nb = 640 // blk
            npool = 12 * nb  # the 8 slots' tables leave blocks no slot maps
            codes_scales = []
            for _ in range(2):
                x = (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
                     * torch.exp(0.7 * torch.randn((npool, 16, 1, 1),
                                                   generator=g, device=dev)))
                c8, sc = cuda_decode.quantize_symmetric_int8(
                    x.reshape(npool, 16, blk * 128), 2)
                codes_scales.append((c8.reshape(npool, 16, blk, 128), sc[..., 0]))
            (kp8, kbs), (vp8, vbs) = codes_scales
            del x
            cks, cvs = (torch.rand((8, 16, 1, 128), generator=g, device=dev)
                        * 0.03 + 0.005 for _ in range(2))
            table = torch.stack([torch.randperm(npool, generator=g,
                                                device=dev)[:nb]
                                 for _ in range(8)]).to(torch.int32)
            used = torch.zeros(npool, dtype=torch.bool, device=dev)
            used[table.long().flatten()] = True
            spare = int((~used).nonzero()[0])
            ksn, vsn = kbs.clone(), vbs.clone()
            ksn[spare], vsn[spare] = math.nan, math.nan
            for tq in (8, 32, 64):
                q = rnd(8, 16, tq, 128)
                qo = torch.randint(0, 640 - tq, (8,), generator=g, device=dev,
                                   dtype=torch.int32)
                qo[0] = 3 * blk - 3  # the window straddles a block boundary
                past = (torch.arange(nb, device=dev)[None] * blk
                        >= (qo + tq)[:, None])
                nan_table = torch.where(past, spare, table).to(torch.int32)
                kinds = ((None, "chain"),) if tq == 64 else (
                    (None, "chain"), (random_trees(8, tq, 1, tq + blk).to(dev),
                                      "tree"))
                for tm, kind in kinds:
                    for sk, sc in (("per-block", (kbs, vbs)),
                                   ("channel", (cks, cvs))):
                        name = f"B2 cast block{blk} Tq{tq} {kind} {sk}"
                        kw = dict(causal=True, q_offset=qo, block_table=table,
                                  tree_mask=tm)
                        got = int8_call(b2, lambda: q8_route("q8")(
                            q, kp8, vp8, *sc, **kw))
                        int8_check(name, got, q8_route("q8", plain=True)(
                            q, kp8, vp8, *sc, **kw))
                        if sk == "per-block":
                            int8_bits[f"{name}: NaN scalars past the window "
                                      f"unread"] = same(got, q8_route("q8")(
                                          q, kp8, vp8, ksn, vsn, **dict(
                                              kw, block_table=nan_table)))
                if tq < 64:
                    tril = torch.tril(torch.ones(tq, tq, dtype=torch.bool,
                                                 device=dev)).expand(8, tq, tq)
                    kw = dict(causal=True, q_offset=qo, block_table=table)
                    int8_bits[f"B2 cast block{blk} Tq{tq} tril == causal"] = same(
                        q8_route("q8")(q, kp8, vp8, kbs, vbs, **kw),
                        q8_route("q8")(q, kp8, vp8, kbs, vbs, tree_mask=tril,
                                       **kw))
                if blk == 16 and tq == 8:
                    # The gate's teeth at the cast route's multi-row shape,
                    # several blocks (and so scalars) in each 64-key tile.
                    teeth = q8q_teeth((q, kp8, vp8, table, kbs, vbs, qo), b2,
                                      route="q8")
                    int8_teeth.update({f"B2 cast {f}": {"pass": r[0],
                                                        "rel": r[2],
                                                        "dlse": r[3]}
                                       for f, r in teeth.items()})
                if tq == 64:
                    # local_blocks: the 64-row chunk over W ranks' slices; each
                    # rank's slice gets a block 0 and its unnamed blocks with
                    # NaN scalars (held entries shift by one; past each window
                    # they name block 0, held but never read).
                    for W in (2, 4):
                        nl = npool // W
                        parts = []
                        for r in range(W):
                            loc = table - r * nl
                            held = (loc >= 0) & (loc < nl)
                            lpois = torch.where(held, torch.where(past, 0,
                                                                  loc + 1),
                                                -1).to(torch.int32)
                            sl = slice(r * nl, (r + 1) * nl)
                            kr = torch.cat([kp8[:1] * 0, kp8[sl]])
                            vr = torch.cat([vp8[:1] * 0, vp8[sl]])
                            named = torch.zeros(nl + 1, dtype=torch.bool,
                                                device=dev)
                            named[lpois[lpois > 0].long()] = True
                            scp = tuple(torch.where(
                                named[:, None], torch.cat([x[:1], x[sl]]),
                                math.nan) for x in (kbs, vbs))
                            got = int8_call(b2, lambda: b2(
                                q, kr, vr, lpois, q_offset=qo, block_scales=scp,
                                local_blocks=True, local_shards=W))
                            int8_check(
                                f"B2 cast local W{W} rank{r} block{blk} Tq64 "
                                f"(unnamed blocks' scalars NaN)", got,
                                cuda_decode.paged_decode_plain(
                                    q, kp8[sl], vp8[sl],
                                    torch.where(held, loc, -1).to(torch.int32),
                                    q_offset=qo,
                                    block_scales=tuple(x[sl] for x in (kbs,
                                                                       vbs)),
                                    local_blocks=True))
                            parts.append(got)
                        merged = merge_partials(
                            torch.stack([o.float() for o, _ in parts]),
                            torch.stack([l for _, l in parts]))
                        int8_check(f"B2 cast local W{W} block{blk} Tq64: "
                                   f"{W} partials merged vs unsharded B2",
                                   merged, b2(q, kp8, vp8, table, q_offset=qo,
                                              block_scales=(kbs, vbs)))
        del kp8, vp8, ksn, vsn
        # Saturated codes: every K code at +-127 (B4 with every Q code at
        # +-127 too: each row +-1 before the fold).
        q = (torch.randint(0, 2, (8, 16, 8, 128), generator=g, device=dev) * 2
             - 1).to(torch.bfloat16)
        kq = (torch.randint(0, 2, (8, 16, 640, 128), generator=g, device=dev,
                            dtype=torch.int8) * 2 - 1) * 127
        vq = torch.randint(-127, 128, (8, 16, 640, 128), generator=g,
                           device=dev, dtype=torch.int8)
        ks, vs = (torch.rand((8, 16, 1, 128), generator=g, device=dev) * 0.03
                  + 0.005 for _ in range(2))
        qo = torch.randint(0, 632, (8,), generator=g, device=dev,
                           dtype=torch.int32)
        codes, _ = cuda_decode._fold_quantize_q(q, 16, torch.ones_like(ks),
                                                None)
        if not bool((codes.abs() == 127).all()):
            fail("saturated case: Q codes are not all +-127")
        for kind, route, w in routes:
            kw = dict(causal=True, q_offset=qo)
            int8_check(f"{kind} saturated codes D128 Tq8",
                       int8_call(w, lambda: q8_route(route)(
                           q, kq, vq, torch.ones_like(ks), vs, **kw)),
                       q8_route(route, plain=True)(q, kq, vq,
                                                   torch.ones_like(ks), vs,
                                                   **kw))
        del q, kq, vq, codes
        print(f"multi-row B4 and cast route, row gate: {len(int8_gate)} cases "
              f"pass, worst relative "
              f"{max(c['max_rel_err'] for c in int8_gate.values()):.3e}, |dlse| "
              f"{max(c['max_abs_err_lse'] for c in int8_gate.values()):.3e}; "
              f"bit for bit {json.dumps(int8_bits)}; the gate's teeth "
              f"{json.dumps(int8_teeth)}", flush=True)
        if not all(int8_bits.values()):
            fail(f"multi-row B4/cast bit-for-bit checks: {int8_bits}")
        if not int8_teeth["B2 cast None"]["pass"] or any(
                r["pass"] for f, r in int8_teeth.items() if f != "B2 cast None"):
            fail(f"multi-row B4/cast: the gate fails its own arithmetic or "
                 f"accepts a planted fault: {int8_teeth}")
        # Timed: B4 at the contiguous chain verify tick and GQA Tq 16; the cast
        # route at the contiguous tree tick and GQA Tq 16, and on the paged
        # layout at the chain tick and the 64-row chunk (per-block scales).
        for tq, B, hq, hkv, tk in ((8, 8, 16, 16, 640), (16, 8, 32, 8, 4037)):
            q = rnd(B, hq, tq, 128)
            kq, vq, ks, vs = cuda_decode.quantize_kv_channelwise(
                rnd(B, hkv, tk, 128), rnd(B, hkv, tk, 128))
            qoff = torch.randint(0, tk - tq, (B,), generator=g, device=dev,
                                 dtype=torch.int32)
            need = sum(min(tk, int(o) + tq) for o in qoff.tolist())
            pairs = hq * visible_pairs(qoff, tq, tk)
            kd, vd, mask = deq(kq, ks), deq(vq, vs), gqa_mask(qoff, tq, tk)
            nbytes = (need * hkv * 128 * 2 + q.numel() * 4 + 4 * ks.numel() * 4)
            shape = (f"B8 H16 Tk640 Tq8 chain" if tq == 8 else
                     f"GQA B8 Hq32 Hkv8 Tk{tk} Tq16 ragged")
            record("flash_decode_q8q_tiled", f"int8 {shape}",
                   lambda: b4(q, kq, vq, ks, vs, causal=True, q_offset=qoff),
                   lambda: cuda_decode.decode_q8q_plain(
                       q, kq, vq, ks, vs, causal=True, q_offset=qoff),
                   None, nbytes, 0.0, ops_s=q8_ops_s(pairs, True),
                   yardstick=lambda: F.scaled_dot_product_attention(
                       q, kd, vd, attn_mask=mask, enable_gqa=True),
                   names=own, parts=("decode_tiled", "merge_splits"))
            if tq == 8:  # the cast route's contiguous verify tick: a tree
                trees = random_trees(B, 8, 1, 9).to(dev)
                keys, tpairs = tree_counts(trees, qoff, tk)
                tmask = tree_sdpa_mask(trees, qoff, tk)
                record("flash_decode_cast_tiled", "int8 B8 H16 Tk640 Tq8 tree, "
                       "cast",
                       lambda: cuda_decode.attention_cuda_decode_q8(
                           q, kq, vq, ks, vs, causal=True, q_offset=qoff,
                           tree_mask=trees),
                       lambda: cuda_decode.decode_q8_plain(
                           q, kq, vq, ks, vs, causal=True, q_offset=qoff,
                           tree_mask=trees),
                       None, keys * 16 * 128 * 2 + q.numel() * 4
                       + 4 * ks.numel() * 4, 0.0,
                       ops_s=q8_ops_s(16 * tpairs, False),
                       yardstick=lambda: F.scaled_dot_product_attention(
                           q, kd, vd, attn_mask=tmask), names=own)
            else:
                record("flash_decode_cast_tiled", f"int8 {shape}, cast",
                       lambda: cuda_decode.attention_cuda_decode_q8(
                           q, kq, vq, ks, vs, causal=True, q_offset=qoff),
                       lambda: cuda_decode.decode_q8_plain(
                           q, kq, vq, ks, vs, causal=True, q_offset=qoff),
                       None, nbytes, 0.0, ops_s=q8_ops_s(pairs, False),
                       yardstick=lambda: F.scaled_dot_product_attention(
                           q, kd, vd, attn_mask=mask, enable_gqa=True),
                       names=own)
            del kq, vq, kd, vd, mask
        blk, nb, npool = 64, 10, 96
        (kp8, kbs), (vp8, vbs) = (
            (c.reshape(npool, 16, blk, 128), sc[..., 0]) for c, sc in (
                cuda_decode.quantize_symmetric_int8(
                    (torch.randn((npool, 16, blk, 128), generator=g, device=dev)
                     * torch.exp(0.7 * torch.randn((npool, 16, 1, 1),
                                                   generator=g, device=dev))
                     ).reshape(npool, 16, blk * 128), 2) for _ in range(2)))
        table = torch.stack([torch.randperm(npool, generator=g, device=dev)[:nb]
                             for _ in range(8)]).to(torch.int32)
        kgd, vgd = gather_paged_kv(deq(kp8, kbs[..., None, None]),
                                   deq(vp8, vbs[..., None, None]), table)
        for tq in (8, 64):
            q = rnd(8, 16, tq, 128)
            qoff = torch.randint(0, nb * blk - tq, (8,), generator=g, device=dev,
                                 dtype=torch.int32)
            need = sum(min(nb * blk, int(o) + tq) for o in qoff.tolist())
            mask = gqa_mask(qoff, tq, nb * blk)
            record("flash_decode_paged_cast_tiled",
                   f"int8 B8 H16 block64 NB10 Tq{tq} "
                   f"{'chain' if tq == 8 else 'chunk'}, per-block scales",
                   lambda: b2(q, kp8, vp8, table, q_offset=qoff,
                              block_scales=(kbs, vbs)),
                   lambda: cuda_decode.paged_decode_plain(
                       q, kp8, vp8, table, q_offset=qoff,
                       block_scales=(kbs, vbs)),
                   None, need * 16 * 128 * 2 + q.numel() * 4
                   + 2 * 8 * nb * 16 * 4, 0.0,
                   ops_s=q8_ops_s(16 * visible_pairs(qoff, tq, nb * blk), False),
                   yardstick=lambda: F.scaled_dot_product_attention(
                       q, kgd, vgd, attn_mask=mask), names=own,
                   parts=("decode_tiled", "merge_splits"))
        del kp8, vp8, kgd, vgd, mask, q
        torch.cuda.empty_cache()

        # B3: a Tq=256 prefill chunk against a 2k-token gathered view.
        q, k, v = rnd(8, 16, 256, 128), rnd(8, 16, 2048, 128), rnd(8, 16, 2048, 128)
        qoff = torch.randint(0, 2048 - 256, (8,), generator=g, device=dev,
                             dtype=torch.int32)
        need = sum(min(2048, int(o) + 256) for o in qoff.tolist())
        mask = gqa_mask(qoff, 256, 2048)
        record("flash_fwd", "B8 H16 Tq256 Tk2048 ragged",
               lambda: cuda_attention.attention_cuda_fwd(
                   q, k, v, causal=True, q_offset=qoff),
               lambda: cuda_attention.fwd_plain(q, k, v, causal=True,
                                                q_offset=qoff),
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
               need * 16 * 128 * 2 * 2 + 2 * q.numel() * 2,
               4.0 * 16 * 128 * visible_pairs(qoff, 256, 2048))
        # The gate has teeth for B3's tiling: it rejects each row's causal
        # frontier shifted by one key (the plain version at q_offset + 1).
        shift = gate(cuda_attention.fwd_plain(q, k, v, causal=True,
                                              q_offset=qoff + 1),
                     cuda_attention.fwd_plain(q, k, v, causal=True,
                                              q_offset=qoff))
        print(f"gate: B3's frontier shifted by one key -> relative |dout| "
              f"{shift[2]:.3e}, |dlse| {shift[3]:.3e}; rejected: "
              f"{not shift[0]}", flush=True)
        if shift[0]:
            fail("the parity gate accepts B3's frontier shifted by one key")
        del q, k, v, mask
        # ... and the training forward: B2 H16 T4096 causal (the train phase's
        # attention shape).
        q, k, v = (rnd(2, 16, 4096, 128) for _ in range(3))
        record("flash_fwd", "train B2 H16 T4096 causal",
               lambda: cuda_attention.attention_cuda_fwd(q, k, v, causal=True),
               lambda: cuda_attention.fwd_plain(q, k, v, causal=True),
               lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
               4 * q.numel() * 2 + 2 * 16 * 4096 * 4,
               4.0 * 128 * causal_pairs(2, 16, 4096, 4096, 0, 0))
        del q, k, v
        # ... and whole admission's cold prefill (phase 3h): one prompt, Tq =
        # Tk = its bucket, query offset 0.
        for t in (512, 640):
            q, k, v = (rnd(1, 16, t, 128) for _ in range(3))
            record("flash_fwd", f"whole prefill B1 H16 Tq=Tk{t} causal",
                   lambda: cuda_attention.attention_cuda_fwd(q, k, v,
                                                             causal=True),
                   lambda: cuda_attention.fwd_plain(q, k, v, causal=True),
                   lambda: F.scaled_dot_product_attention(q, k, v,
                                                          is_causal=True),
                   4 * q.numel() * 2 + 16 * t * 4,
                   4.0 * 128 * causal_pairs(1, 16, t, t, 0, 0))
            del q, k, v
        torch.cuda.empty_cache()

        # -- 2b. the backward kernels B6 and B7 against their plain versions ---
        def gate_rows(got, want, one_key=None):
            """Every row of each gradient (dq rows per query, dk/dv rows per
            key) within TOL_GRAD_REL of that row's largest plain |value| (a row
            that is 0 in the plain version must be exactly 0); with ``one_key``
            (``cuda_bwd.dq_one_key_bound``) dq's one-key rows within their
            rounding bound. Returns ``(ok, max |d|, max relative |d|)``."""
            return cuda_bwd.grad_rows_close(got, want, TOL_GRAD_REL, one_key)

        def bwd_inputs(B, Hq, Hkv, Tq, Tk, qo, ko):
            q, k, v = rnd(B, Hq, Tq, 128), rnd(B, Hkv, Tk, 128), rnd(B, Hkv, Tk,
                                                                     128)
            dout = rnd(B, Hq, Tq, 128)
            out, lse = cuda_attention.attention_cuda_fwd(  # gated above
                q, k, v, causal=True, q_offset=qo, kv_offset=ko)
            lse_f, delta = cuda_bwd.bwd_residuals(out, lse, dout)
            return q, k, v, dout, lse_f, delta

        def sdpa_bwd(q, k, v, dout, qo, ko):
            """SDPA's backward on the same inputs (flash backend for the plain
            causal square, a boolean mask otherwise): the yardstick only."""
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            Tq, Tk = q.shape[2], k.shape[2]
            if qo == 0 and ko == 0 and Tq == Tk and q.shape[1] == k.shape[1]:
                o = F.scaled_dot_product_attention(*leaves, is_causal=True)
            else:
                pos = torch.arange(Tq, device=dev)[:, None] + qo
                mask = torch.arange(Tk, device=dev)[None] + ko <= pos
                o = F.scaled_dot_product_attention(
                    *leaves, attn_mask=mask, enable_gqa=q.shape[1] != k.shape[1])
            return lambda: torch.autograd.grad(o, leaves, dout,
                                               retain_graph=True)

        def bwd_bound(nbytes, flops):
            t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
            return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"

        def record_bwd(name, shape, with_plain=True):
            B, Hq, Hkv, Tq, Tk, qo, ko = shape
            q, k, v, dout, lse_f, delta = bwd_inputs(*shape)
            kw = dict(causal=True, q_offset=qo, kv_offset=ko)
            one_key = (cuda_bwd.dq_one_key_bound(q, k, v, dout, delta, **kw)
                       if with_plain else None)
            pairs = causal_pairs(B, Hq, Tq, Tk, qo, ko)
            io = (q.numel() + dout.numel()) * 2 + 2 * lse_f.numel() * 4
            kv = 2 * k.numel() * 2
            # SDPA's backward does the whole gradient: at least the q.k, dO.v,
            # ds.k, ds^T.q and p^T.dO products, 10 * pairs * D FLOPs.
            lib_ms, lib_clock, _ = time_ms(
                sdpa_bwd(q, k, v, dout, qo, ko),
                bwd_bound(io + 3 * kv + q.numel() * 2, 10.0 * pairs * 128)[0],
                iters=5)
            for kernel, fn, plain, nbytes, flops in (
                    ("flash_dq",
                     lambda: (cuda_bwd.attention_cuda_dq(
                         q, k, v, dout, lse_f, delta, **kw),),
                     lambda: (cuda_bwd.dq_plain(q, k, v, dout, lse_f, delta,
                                                **kw),),
                     io + kv + q.numel() * 2, 6.0 * pairs * 128),
                    ("flash_dkv",
                     lambda: cuda_bwd.attention_cuda_dkv(
                         q, k, v, dout, lse_f, delta, **kw),
                     lambda: cuda_bwd.dkv_plain(q, k, v, dout, lse_f, delta,
                                                **kw),
                     io + 2 * kv, 8.0 * pairs * 128)):
                bound, bound_by = bwd_bound(nbytes, flops)
                c = {"kernel": kernel, "case": name, "bound_ms": bound,
                     "bound_by": bound_by, "library_ms": lib_ms}
                if with_plain:
                    ok, eabs, erel = gate_rows(fn(), plain(), one_key if
                                               kernel == "flash_dq" else None)
                    if not ok:
                        fail(f"{kernel} {name}: |d| {eabs:.3e}, relative "
                             f"{erel:.3e} (tol {TOL_GRAD_REL})")
                    c["plain_ms"], plain_clock, _ = time_ms(plain, bound,
                                                            iters=3)
                    c.update(max_abs_err=eabs, max_rel_err=erel)
                else:
                    plain_clock = None
                    c.update(plain_ms=None, max_abs_err=None, max_rel_err=None)
                c["ms"], clock, _ = time_ms(fn, bound, iters=5)
                c["clocks"] = [clock, plain_clock, lib_clock]
                cases.append(c)
                print(f"{kernel} {name}: |d| {c['max_abs_err']} relative "
                      f"{c['max_rel_err']} (tol {TOL_GRAD_REL}) ms {c['ms']:.4f} "
                      f"plain {c['plain_ms']} sdpa_bwd {lib_ms:.4f} bound "
                      f"{bound:.4f} ({bound_by}) clocks {c['clocks']}",
                      flush=True)
            return q, k, v, dout, lse_f, delta

        train_shape = (2, 16, 16, 4096, 4096, 0, 0)
        tq_in = record_bwd("train B2 H16 T4096 causal", train_shape)
        for name, shape in (
                ("GQA B2 Hq32 Hkv8 Tq2048 Tk2048 q_offset1000",
                 (2, 32, 8, 2048, 2048, 1000, 0)),
                ("ragged B2 H16 Tq100 Tk300 q_offset200",
                 (2, 16, 16, 100, 300, 200, 0)),
                ("unaligned B2 H16 T256 kv_offset100",
                 (2, 16, 16, 256, 256, 0, 100))):
            record_bwd(name, shape)
        # The gate has teeth at the training shape: it rejects dv halved, and
        # B7 leaving out each KV tile's first live Q tile.
        q, k, v, dout, lse_f, delta = tq_in
        want = cuda_bwd.dkv_plain(q, k, v, dout, lse_f, delta, causal=True)
        dk, dv = cuda_bwd.attention_cuda_dkv(q, k, v, dout, lse_f, delta,
                                             causal=True)
        halved = gate_rows((dk, dv * 0.5), want)
        # ... and B6's causal frontier shifted by one key (the plain dq at
        # q_offset 1, on the same lse and delta).
        dq_shift = gate_rows(
            (cuda_bwd.dq_plain(q, k, v, dout, lse_f, delta, causal=True,
                               q_offset=1),),
            (cuda_bwd.dq_plain(q, k, v, dout, lse_f, delta, causal=True),),
            cuda_bwd.dq_one_key_bound(q, k, v, dout, delta, causal=True))
        # What B7 would give without each KV tile's first live Q tile: the
        # plain dk/dv less that (Q tile, KV tile) pair's share, which is the
        # plain version on the pair's rows and keys at their offsets.
        bq, bk = DKV_TILES["bfloat16"]
        share = ([], [])
        for ki in range(4096 // bk):
            qi = first_live_q(ki, bq, bk, 0, 0, 4096 // bq)
            rows, keys = slice(qi * bq, (qi + 1) * bq), slice(ki * bk,
                                                               (ki + 1) * bk)
            for acc, part in zip(share, cuda_bwd.dkv_plain(
                    q[:, :, rows], k[:, :, keys], v[:, :, keys], dout[:, :, rows],
                    lse_f[:, :, rows], delta[:, :, rows], causal=True,
                    q_offset=qi * bq, kv_offset=ki * bk)):
                acc.append(part.float())
        skipped = gate_rows(tuple(w.float() - torch.cat(acc, 2)
                                  for w, acc in zip(want, share)), want)
        print(f"gate: dv halved -> relative |d| {halved[2]:.3e}; B7's first "
              f"live Q tile skipped -> relative |d| {skipped[2]:.3e}; B6's "
              f"frontier shifted by one key -> relative |d| {dq_shift[2]:.3e}; "
              f"all rejected: {not (halved[0] or skipped[0] or dq_shift[0])}",
              flush=True)
        if halved[0] or skipped[0] or dq_shift[0]:
            fail("the gradient gate accepts a planted fault at the training "
                 "shape")
        # B6/B7 with a non-zero lse cotangent, as the tree merge's weights give
        # them (delta = rowsum(dO * O) - dlse), against their plain versions at
        # the training shape; the one-key dq rows, no longer 0 (dlse K_0
        # scale), held to the row gate plus the cancellation's rounding bound;
        # the gate shown rejecting dlse left out of delta.
        out_t, lse_t = cuda_attention.attention_cuda_fwd(q, k, v, causal=True)
        dlse_t = torch.randn(lse_t.shape, generator=g, device=dev)
        _, delta_d = cuda_bwd.bwd_residuals(out_t, lse_t, dout, dlse_t)
        one_key_d = cuda_bwd.dq_one_key_bound(q, k, v, dout, delta_d,
                                              causal=True, dlse=dlse_t)

        def bwd_kernels(dl):
            return (cuda_bwd.attention_cuda_dq(q, k, v, dout, lse_f, dl,
                                               causal=True),
                    *cuda_bwd.attention_cuda_dkv(q, k, v, dout, lse_f, dl,
                                                 causal=True))

        want_d = (cuda_bwd.dq_plain(q, k, v, dout, lse_f, delta_d, causal=True),
                  *cuda_bwd.dkv_plain(q, k, v, dout, lse_f, delta_d,
                                      causal=True))
        got_d = bwd_kernels(delta_d)
        with_dlse = gate_rows(got_d, want_d, one_key_d)
        dlse_left_out = gate_rows(bwd_kernels(delta), want_d, one_key_d)
        rows_d, bound_d = one_key_d
        sel = rows_d.expand_as(bound_d)
        allowed_d = (TOL_GRAD_REL * want_d[0].float().abs().amax(-1, keepdim=True)
                     + bound_d)
        dlse_bwd = {
            "pass": with_dlse[0], "max_abs_err": with_dlse[1],
            "max_rel_err": with_dlse[2],
            "one_key_max_diff_over_allowed": (
                (got_d[0].float() - want_d[0].float()).abs()[sel]
                / allowed_d.expand_as(bound_d)[sel]).max().item(),
            "one_key_max_abs_plain": want_d[0].float().abs()[sel].max().item(),
            "dlse_left_out": {"pass": dlse_left_out[0],
                              "max_rel_err": dlse_left_out[2]}}
        print(f"B6/B7 with a non-zero dlse (train shape): |d| "
              f"{with_dlse[1]:.3e}, relative {with_dlse[2]:.3e} (tol "
              f"{TOL_GRAD_REL}); one-key dq rows at "
              f"{dlse_bwd['one_key_max_diff_over_allowed']:.3e} of their "
              f"allowance; dlse left out of delta -> relative "
              f"{dlse_left_out[2]:.3e}, rejected {not dlse_left_out[0]}",
              flush=True)
        if not with_dlse[0]:
            fail(f"B6/B7 with a non-zero dlse differ from plain: relative "
                 f"{with_dlse[2]:.3e}")
        if dlse_left_out[0]:
            fail("the gradient gate accepts dlse left out of delta")
        del out_t, lse_t, dlse_t, delta_d, one_key_d, want_d, got_d, rows_d
        del bound_d, sel, allowed_d
        # The one-key dq rows at the training shape (row 0 of every head): the
        # kernel against the plain version there, beside their bound, and the
        # row gate without the one-key rule (reported, not gated).
        rows, bound = cuda_bwd.dq_one_key_bound(q, k, v, dout, delta, causal=True)
        dq_k = cuda_bwd.attention_cuda_dq(q, k, v, dout, lse_f, delta, causal=True)
        dq_p = cuda_bwd.dq_plain(q, k, v, dout, lse_f, delta, causal=True)
        sel = rows.expand_as(bound)
        d1 = (dq_k.float() - dq_p.float()).abs()[sel]
        one_key_rows = {
            "max_abs_diff": d1.max().item(),
            "max_abs_plain": dq_p.float().abs()[sel].max().item(),
            "min_bound": bound[sel].min().item(),
            "max_diff_over_bound": (d1 / bound[sel]).max().item(),
            "strict_row_gate_pass": gate_rows((dq_k,), (dq_p,))[0]}
        print(f"B6's one-key dq rows (train shape): {json.dumps(one_key_rows)}",
              flush=True)
        del rows, bound, dq_k, dq_p, sel, d1
        del q, k, v, dout, lse_f, delta, tq_in, want, dk, dv, share
        torch.cuda.empty_cache()
        # Every body and instantiation that ships, off its tile edges: B3 and
        # B6/B7 in bf16 (the tensor-core bodies of B3 and B6) and f32 (the
        # CUDA-core bodies), D 64 and 128, Tq 5 and 130 against Tk 300, GQA
        # Hq4 Hkv2, per batch row q_offset -3 (rows that see no key, then one
        # key) or 170 with kv_offset 37 (off every tile edge), causal and not,
        # each against its plain version under the gates above; the residuals
        # come from the plain forward.
        edges = []
        qo_e = torch.tensor([-3, 170], dtype=torch.int32, device=dev)
        ko_e = torch.tensor([0, 37], dtype=torch.int32, device=dev)
        for dtype in (torch.bfloat16, torch.float32):
            for D in (64, 128):
                for Tq, causal in ((5, True), (130, True), (130, False)):
                    q, dout = (torch.randn(2, 4, Tq, D, generator=g, device=dev
                                           ).to(dtype) for _ in range(2))
                    k, v = (torch.randn(2, 2, 300, D, generator=g, device=dev
                                        ).to(dtype) for _ in range(2))
                    kw = dict(causal=causal, q_offset=qo_e, kv_offset=ko_e)
                    want = cuda_attention.fwd_plain(q, k, v, **kw)
                    f_ok, _, f_rel, f_lse = gate(
                        cuda_attention.attention_cuda_fwd(q, k, v, **kw), want)
                    lse_f, delta = cuda_bwd.bwd_residuals(*want, dout)
                    args = (q, k, v, dout, lse_f, delta)
                    b_ok, _, b_rel = gate_rows(
                        (cuda_bwd.attention_cuda_dq(*args, **kw),
                         *cuda_bwd.attention_cuda_dkv(*args, **kw)),
                        (cuda_bwd.dq_plain(*args, **kw),
                         *cuda_bwd.dkv_plain(*args, **kw)),
                        cuda_bwd.dq_one_key_bound(q, k, v, dout, delta, **kw))
                    edges.append({"dtype": str(dtype).removeprefix("torch."),
                                  "D": D, "Tq": Tq, "Tk": 300, "causal": causal,
                                  "fwd_rel": f_rel, "fwd_dlse": f_lse,
                                  "bwd_rel": b_rel, "ok": f_ok and b_ok})
        torch.cuda.synchronize()
        print(f"tile edges (B3, B6, B7; bf16 and f32, D 64/128, Tq 5/130, Tk "
              f"300): worst out relative "
              f"{max(e['fwd_rel'] for e in edges):.3e}, |dlse| "
              f"{max(e['fwd_dlse'] for e in edges):.3e}, gradient relative "
              f"{max(e['bwd_rel'] for e in edges):.3e}; "
              f"{sum(e['ok'] for e in edges)}/{len(edges)} pass", flush=True)
        bad = [e for e in edges if not e["ok"]]
        if bad:
            fail(f"a kernel differs from its plain version at a tile edge: "
                 f"{json.dumps(bad)}")
        del q, k, v, dout, lse_f, delta, want, args
        # BASELINE.json's "causal forward+backward, seq 16384" shape: timing
        # only (the plain versions would materialise 17 GB of scores per array).
        long_shape = (1, 16, 16, 16384, 16384, 0, 0)
        q, k, v = (rnd(1, 16, 16384, 128) for _ in range(3))
        bound, bound_by = bwd_bound(
            4 * q.numel() * 2 + 16 * 16384 * 4,
            4.0 * 128 * causal_pairs(1, 16, 16384, 16384, 0, 0))
        fwd_ms, fwd_clock, _ = time_ms(
            lambda: cuda_attention.attention_cuda_fwd(q, k, v, causal=True),
            bound, iters=3)
        sdpa_ms, sdpa_clock, _ = time_ms(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            bound, iters=3)
        cases.append({"kernel": "flash_fwd", "case": "long B1 H16 T16384 causal",
                      "ms": fwd_ms, "plain_ms": None, "library_ms": sdpa_ms,
                      "bound_ms": bound, "bound_by": bound_by,
                      "max_abs_err": None, "clocks": [fwd_clock, None,
                                                      sdpa_clock]})
        print(f"flash_fwd long B1 H16 T16384 causal: ms {fwd_ms:.4f} sdpa "
              f"{sdpa_ms:.4f} bound {bound:.4f} ({bound_by})", flush=True)
        del q, k, v
        record_bwd("long B1 H16 T16384 causal", long_shape, with_plain=False)
        del flush_buf
        torch.cuda.empty_cache()
        # The Tq < 128 training route: B1 forward, then the plain blockwise
        # backward (as JAX differentiates its decode kernel), through
        # flash_attention under grad, against the same route's plain forward.
        leaves = [rnd(*s).requires_grad_() for s in
                  ((2, 32, 64, 128), (2, 8, 2048, 128), (2, 8, 2048, 128))]
        dout, dlse = rnd(2, 32, 64, 128), rnd(2, 32, 64).float()
        routes = {}
        for impl in ("auto", "plain"):
            o, lse = flash_attention(*leaves, causal=True, q_offset=1984,
                                     impl=impl)
            routes[impl] = torch.autograd.grad(
                (o.float() * dout.float()).sum() + (lse * dlse).sum(), leaves)
        ok, eabs, erel = gate_rows(routes["auto"], routes["plain"])
        print(f"decode-route grads (B1 + blockwise bwd, GQA Hq32 Hkv8 Tq64 "
              f"Tk2048): |d| {eabs:.3e} relative {erel:.3e} (tol "
              f"{TOL_GRAD_REL})", flush=True)
        if not ok:
            fail(f"decode-route grads differ: relative {erel:.3e}")
        del leaves, dout, dlse, routes

    if "3" in run:
        mark("3")
        # -- 3. serve through the paged, chunked SlotServer --------------------
        serve_cfg = parse_args(SERVE_ARGS)
        reset_counts()
        t0 = time.monotonic()
        rec, server, serve_rep = cli.run_serve(serve_cfg, dev)
        torch.cuda.synchronize()
        serve_wall = time.monotonic() - t0
        launches = {n: w.launches for n, w in wrappers.items()}
        # B2's multi-row body: the prompt-tail ticks (chunk buckets below 128
        # rows run every slot's rows through B2 at that Tq), by Tq bucket.
        b2w = cuda_decode.attention_cuda_decode_paged
        launches["flash_decode_paged_tiled"] = b2w.tiled_launches
        launches["flash_decode_paged_tick"] = b2w.tick_launches
        serve_tiled_tq = dict(sorted(b2w.tiled_tq.items()))
        serve_tiled["serve"] = tiled_by_tq()
        print(f"serve: {rec['requests']} requests, {rec['tokens_generated']} "
              f"tokens, {rec['tokens_per_sec']} tok/s, ttft_p50 "
              f"{rec['ttft_p50_s']}s, tbt_p50 {rec['tbt_p50_s']}s, tbt_p95 "
              f"{rec['tbt_p95_s']}s, ticks {rec['ticks']}, launches "
              f"{json.dumps(launches)}, wall incl. init {serve_wall:.2f}s",
              flush=True)
        if rec["outcomes"] != {"budget": 16}:
            fail(f"serve outcomes {rec['outcomes']}")
        if rec["tokens_generated"] != 16 * 64:  # every request its 64 tokens
            fail(f"serve generated {rec['tokens_generated']} tokens")
        if any(rec["leaks"][k] for k in rec["leaks"]):
            fail(f"serve leaked: {rec['leaks']}")
        for n in ("flash_decode_paged", "flash_decode_paged_tiled",
                  "flash_decode_paged_tick", "flash_fwd"):
            if launches[n] == 0:
                fail(f"serve never launched {n}")
        # Every one-row tick ran on the tick body: B2's launches are its
        # multi-row ones and its ticks, nothing on the split body.
        off_tick = (launches["flash_decode_paged"] - b2w.tiled_launches
                    - b2w.tick_launches)
        print(f"serve: B2's multi-row body launched {b2w.tiled_launches} times "
              f"(by Tq bucket {json.dumps(serve_tiled_tq)}), its tick body "
              f"{b2w.tick_launches}, its split body {off_tick}", flush=True)
        if off_tick:
            fail("serve: a one-row paged tick ran off the tick body")
        single_tokens = {r.uid: r.tokens for r in serve_rep.results}
        single_pool_bytes = server.pool_bytes()

        # Where a serve step's time goes: one more wave (8 requests) on the
        # same weights, served once untraced (its wall) and once traced (its
        # device time; the profiler slows the host, so its own wall is longer).
        tcfg, params = server.cfg, server.params
        trace = synthetic_trace(8, prompt_len=512, prompt_jitter=64,
                                max_new_tokens=64, vocab_size=tcfg.vocab_size,
                                seed=7)

        def wave(**kw):
            engine = SlotServer(params, tcfg, slots=8, cache_len=640,
                                prefill_chunk=256, kv_block=64, **kw)
            rep = engine.serve(trace)
            torch.cuda.synchronize()
            return rep

        def wave_breakdown(label, groups, **kw):
            """One wave served untraced (its wall) and once traced (its device
            time; the profiler slows the host, so its own wall is longer)."""
            plain_rep = wave(**kw)
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                prof_rep = wave(**kw)
            split, by_kernel = split_by(prof, groups)
            busy = sum(split.values())
            wall_ms = plain_rep.wall_s * 1e3
            traced_wall_ms = prof_rep.wall_s * 1e3
            bd = {
                "serve_wall_ms": wall_ms,
                "traced_serve_wall_ms": traced_wall_ms,
                "device_busy_ms": busy,
                "idle_share": (1 - busy / wall_ms) if busy else None,
                "idle_share_of_traced_wall": (1 - busy / traced_wall_ms)
                if busy else None,
                "by_group_ms": split,
                "top_kernels_ms": dict(sorted(by_kernel.items(),
                                              key=lambda kv: -kv[1])[:12]),
                "tokens_per_sec": plain_rep.tokens_per_sec,
                "traced_tokens_per_sec": prof_rep.tokens_per_sec,
            }
            print(f"{label} breakdown (8 requests): "
                  + (json.dumps({k: round(v, 3) for k, v in split.items()})
                     + f" busy {busy:.2f} ms (traced) of {wall_ms:.2f} ms "
                     f"untraced wall ({traced_wall_ms:.2f} ms traced), idle "
                     f"share {bd['idle_share']:.4f}"
                     if busy else "device time not measured"), flush=True)
            return plain_rep, bd

        plain_rep, breakdown = wave_breakdown("serve", {
            "B2 multi-row body": ("decode_tiled",),
            "B2 tick body (decode ticks)": ("decode_tick",),
            "flash_decode (B1/B2 split body + merge)": ("decode_split",
                                                         "merge_splits"),
            "flash_fwd (B3)": ("flash_fwd",), "matmul": matmul})

        # One mixed step, kernel path vs plain path, on the same cache: slots
        # prefilled to ragged lengths, then decode rows, a 256-row chunk, a
        # short chunk and an inert slot in one step.
        cache = init_paged_cache(tcfg, 8, 640, 80, block=64, device=dev)
        cache.table.copy_(torch.arange(80, device=dev, dtype=torch.int32
                                       ).reshape(8, 10))
        gen = torch.Generator(device=dev).manual_seed(1)
        pre = torch.randint(0, tcfg.vocab_size, (8, 256), generator=gen,
                            device=dev)
        n0 = torch.tensor([256, 17, 0, 200, 64, 1, 256, 128], device=dev,
                          dtype=torch.int32)
        _, cache = forward_step(params, pre, cache, tcfg, n_tokens=n0)
        toks = torch.randint(0, tcfg.vocab_size, (8, 256), generator=gen,
                             device=dev)
        n1 = torch.tensor([1, 1, 256, 40, 0, 1, 100, 1], device=dev,
                          dtype=torch.int32)
        snap = (cache.k.clone(), cache.v.clone())
        lk, ck = forward_step(params, toks, cache, tcfg, n_tokens=n1)
        kv_kernel = (ck.k.clone(), ck.v.clone())
        cache.k.copy_(snap[0])
        cache.v.copy_(snap[1])
        lp, cp = forward_step(params, toks, cache,
                              dataclasses.replace(tcfg, attn_impl="plain"),
                              n_tokens=n1)
        valid = torch.arange(256, device=dev)[None] < n1[:, None]
        logit_err = (lk[valid] - lp[valid]).abs().max().item()
        n_pool = cache.blocks  # block N is the drop target: garbage by design
        kv_err = max((a[:, :n_pool].float() - b[:, :n_pool].float()
                      ).abs().max().item()
                     for a, b in zip(kv_kernel, (cp.k, cp.v)))
        kv_max = max(b[:, :n_pool].float().abs().max().item()
                     for b in (cp.k, cp.v))
        print(f"mixed step: logits |d| {logit_err:.3e} (tol {TOL_LOGITS}), "
              f"written KV |d| {kv_err:.3e} of max |KV| {kv_max:.3e} "
              f"(tol {TOL_KV_REL} x max)", flush=True)
        if not (math.isfinite(logit_err) and logit_err <= TOL_LOGITS):
            fail(f"mixed-step logits differ by {logit_err}")
        if not (math.isfinite(kv_err) and kv_err <= TOL_KV_REL * kv_max):
            fail(f"mixed-step written KV differs by {kv_err} (max |KV| {kv_max})")
        del cache, snap, kv_kernel, lk, lp, ck, cp
        torch.cuda.empty_cache()

        # -- 3b. int8 serve at full width -------------------------------------
        from tree_attention_tpu_torch.models import PagedQuantKVCache

        n_layers = tcfg.n_layers

        def serve_main(label, argv):
            """``cli.main`` in process, with the metrics registry off as in the
            exact serve: its record, the steps it ran over the int8 cache (each
            decode tick runs one; staged chunks run on the exact staging
            cache), the launches (``<kernel>_tiled``: of the multi-row body;
            by Tq in ``serve_tiled[label]``)."""
            reset_counts()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(argv)
            torch.cuda.synchronize()
            rec = json.loads(buf.getvalue().strip().splitlines()[-1])
            counts = {n: w.launches for n, w in wrappers.items()}
            for n in ("flash_decode", "flash_decode_paged",
                      "flash_decode_paged_q8q"):
                counts[n + "_tiled"] = wrappers[n].tiled_launches
            for n in ("flash_decode_paged", "flash_decode_paged_q8q"):
                counts[n + "_tick"] = wrappers[n].tick_launches
            serve_tiled[label] = tiled_by_tq()
            return rec, rec["decode_ticks"], counts

        t0 = time.monotonic()
        q_rec, q_steps, q_launches = serve_main(
            "int8 serve", SERVE_ARGS + ["--kv-quant", "int8"])
        print(f"int8 serve: {q_rec['requests']} requests, "
              f"{q_rec['tokens_generated']} tokens, {q_rec['tokens_per_sec']} "
              f"tok/s, ttft_p50 {q_rec['ttft_p50_s']}s, ttft_p95 "
              f"{q_rec['ttft_p95_s']}s, tbt_p50 {q_rec['tbt_p50_s']}s, tbt_p95 "
              f"{q_rec['tbt_p95_s']}s, ticks {q_rec['ticks']}, int8 steps "
              f"{q_steps}, launches {json.dumps(q_launches)}, "
              f"wall incl. init {time.monotonic() - t0:.2f}s", flush=True)
        if q_rec["outcomes"] != {"budget": 16} or \
                q_rec["tokens_generated"] != 16 * 64:
            fail(f"int8 serve outcomes {q_rec['outcomes']}, "
                 f"{q_rec['tokens_generated']} tokens")
        if any(q_rec["leaks"][k] for k in q_rec["leaks"]):
            fail(f"int8 serve leaked: {q_rec['leaks']}")
        # B5 once per layer and int8 step; staged chunks ran B1 (tails below
        # 128 rows) and B3; the exact paged kernel had nothing to do.
        if not (q_steps > 0 and q_launches["flash_decode_paged_q8q"]
                == n_layers * q_steps):
            fail(f"int8 serve: B5 launched {q_launches['flash_decode_paged_q8q']}"
                 f" times over {q_steps} int8 steps")
        # ... each an int8 decode tick, on the tick body.
        if q_launches["flash_decode_paged_q8q_tick"] != \
                q_launches["flash_decode_paged_q8q"]:
            fail(f"int8 serve: {q_launches['flash_decode_paged_q8q_tick']} of "
                 f"B5's {q_launches['flash_decode_paged_q8q']} launches on the "
                 f"tick body")
        if not (q_launches["flash_decode"] and q_launches["flash_fwd"]) or \
                q_launches["flash_decode_paged"]:
            fail(f"int8 serve staged launches {q_launches}")
        # The staged prompt tails (below 128 rows) run B1's multi-row body.
        if not q_launches["flash_decode_tiled"]:
            fail(f"int8 serve: no staged tail took B1's multi-row body: "
                 f"{q_launches}")
        print(f"int8 serve: the multi-row body's launches by Tq "
              f"{json.dumps(serve_tiled['int8 serve'])}", flush=True)
        c_rec, c_steps, c_launches = serve_main(
            "int8 serve, contiguous",
            SERVE_ARGS + ["--kv-quant", "int8", "--kv-layout", "contiguous",
                          "--requests", "4", "--max-new-tokens", "16"])
        print(f"int8 serve, contiguous: {c_rec['requests']} requests, "
              f"{c_rec['tokens_generated']} tokens, int8 steps "
              f"{c_steps}, B4 launches "
              f"{c_launches['flash_decode_q8q']}", flush=True)
        if c_rec["outcomes"] != {"budget": 4} or not (
                c_steps > 0 and c_launches["flash_decode_q8q"]
                == n_layers * c_steps):
            fail(f"contiguous int8 serve: {c_rec['outcomes']}, "
                 f"{c_launches['flash_decode_q8q']} B4 launches over "
                 f"{c_steps} int8 steps")

        x_rec, x_steps, x_launches = serve_main(
            "int8-cast serve",
            SERVE_ARGS + ["--kv-quant", "int8-cast", "--requests", "4",
                          "--max-new-tokens", "16"])
        print(f"int8-cast serve, paged: {x_rec['requests']} requests, "
              f"{x_rec['tokens_generated']} tokens, int8 steps "
              f"{x_steps}, B2 launches "
              f"{x_launches['flash_decode_paged']} (on the tick body "
              f"{x_launches['flash_decode_paged_tick']})", flush=True)
        if x_rec["outcomes"] != {"budget": 4} or not (
                x_steps > 0 and x_launches["flash_decode_paged"]
                == n_layers * x_steps == x_launches["flash_decode_paged_tick"]) \
                or x_launches["flash_decode_paged_q8q"]:
            fail(f"int8-cast serve: {x_rec['outcomes']}, "
                 f"{x_launches['flash_decode_paged']} B2 launches over "
                 f"{x_steps} int8 steps")

        # The int8 wave: the same 8 requests as the exact wave, on an int8
        # cache; its device time split the same way, B5 apart; and how many of
        # its greedy tokens equal the exact wave's (reported, not gated).
        q8_rep, q8_breakdown = wave_breakdown("int8 serve", {
            "flash_decode_paged_q8q (B5)": ("decode_tick_kernel<signed char, "
                                            "signed char",
                                            "decode_tiled_kernel<1,",
                                            "decode_tiled_kernel<2,"),
            "flash_decode (B1 staged chunks) + merges": ("decode_split",
                                                         "decode_tiled",
                                                         "merge_splits"),
            "flash_fwd (B3)": ("flash_fwd",), "matmul": matmul}, quantize=True)
        exact_tok = {r.uid: r.tokens for r in plain_rep.results}
        same = sum(a == b for r in q8_rep.results
                   for a, b in zip(r.tokens, exact_tok[r.uid]))
        q8_breakdown["tokens_equal_to_exact"] = same / q8_rep.tokens_generated
        print(f"int8 wave: {same} of {q8_rep.tokens_generated} greedy tokens "
              f"equal the exact wave's ({same / q8_rep.tokens_generated:.4f})",
              flush=True)

        # One int8 decode step, kernel path against plain path, on clones of
        # one paged int8 cache: slots prefilled exactly to ragged lengths
        # (three at a block boundary, so the step enters a block), the pools
        # quantized per block, then one token per slot (slot 2 inert).
        cache = init_paged_cache(tcfg, 8, 640, 80, block=64, device=dev)
        cache.table.copy_(torch.arange(80, device=dev, dtype=torch.int32
                                       ).reshape(8, 10))
        _, cache = forward_step(params, pre, cache, tcfg, n_tokens=n0)

        def per_block(pool):
            codes, sc = cuda_decode.quantize_symmetric_int8(
                pool.reshape(*pool.shape[:3], -1), 3)
            return codes.reshape(pool.shape), sc[..., 0]

        (k8, ks8), (v8, vs8) = per_block(cache.k), per_block(cache.v)
        qcache = PagedQuantKVCache(k=k8, v=v8, table=cache.table,
                                   length=cache.length, k_scale=ks8,
                                   v_scale=vs8)
        del cache

        def clone(c):
            return dataclasses.replace(c, **{n: getattr(c, n).clone() for n in (
                "k", "v", "k_scale", "v_scale", "length")})

        tok1 = toks[:, :1]
        n_one = torch.tensor([1, 1, 0, 1, 1, 1, 1, 1], device=dev,
                             dtype=torch.int32)
        q8_step = {}
        for route in ("q8q", "q8"):
            lk, ck = forward_step(params, tok1, clone(qcache), tcfg,
                                  n_tokens=n_one, quant_kernel=route)
            lp, cp = forward_step(params, tok1, clone(qcache),
                                  dataclasses.replace(tcfg, attn_impl="plain"),
                                  n_tokens=n_one, quant_kernel=route)
            live = n_one > 0
            n_pool = qcache.blocks
            err = (lk[live] - lp[live]).abs().max().item()
            diff = [(a[:, :n_pool].int() - b[:, :n_pool].int()).abs()
                    for a, b in ((ck.k, cp.k), (ck.v, cp.v))]
            codes = max(d.max().item() for d in diff)
            n_off = sum(int((d != 0).sum()) for d in diff)
            layer0_equal = all(int(d[0].max()) == 0 for d in diff)
            scales_equal = all(torch.equal(a[:, :n_pool], b[:, :n_pool])
                               for a, b in ((ck.k_scale, cp.k_scale),
                                            (ck.v_scale, cp.v_scale)))
            # The code gate's teeth: the plain path's new K rows quantized
            # under the next head's scalar of their block (a head-stride fault).
            slots = live.nonzero()[:, 0]
            pos = qcache.length[slots].long()
            pb = qcache.table[slots, pos // qcache.block].long().tolist()
            off = (pos % qcache.block).tolist()
            rows = torch.stack([cp.k[:, b, :, o] for b, o in zip(pb, off)]
                               ).float()
            sc = torch.stack([cp.k_scale[:, b] for b in pb])[..., None]
            planted = torch.clamp(torch.round(rows * sc / sc.roll(1, 2)), -127,
                                  127)
            planted_codes = (planted - rows).abs().max().item()
            q8_step[route] = {"logits_err": err, "max_code_diff": codes,
                              "codes_off": n_off, "layer0_codes_equal":
                              layer0_equal, "scales_equal": scales_equal,
                              "planted_next_head_scale_codes": planted_codes}
            print(f"int8 step ({route}), kernel vs plain: logits |d| {err:.3e} "
                  f"(tol {TOL_LOGITS}); written codes equal in layer 0: "
                  f"{layer0_equal}, within {codes} step(s) in all layers (tol "
                  f"{TOL_CODES}; {n_off} codes differ; new rows under the next "
                  f"head's block scale read {planted_codes:.0f}); block scales "
                  f"equal: {scales_equal}", flush=True)
            if not (math.isfinite(err) and err <= TOL_LOGITS and layer0_equal
                    and codes <= TOL_CODES and scales_equal):
                fail(f"int8 step ({route}) kernel and plain paths differ: "
                     f"{q8_step[route]}")
            if planted_codes <= TOL_CODES:
                fail(f"int8 step ({route}): the code gate passes rows quantized "
                     f"under the wrong head's scale ({planted_codes} codes)")
        del qcache, lk, lp, ck, cp, k8, v8
        torch.cuda.empty_cache()

        # -- 3d. speculative serving ------------------------------------------
        # The CLI's --speculate serves (ngram, ngram-tree; exact, int8) on the
        # serve phase's trace, the oracle drafter on the wave's trace on the
        # four layouts (spec_phase), one tree verify step against the plain
        # path and against each root path decoded token by token
        # (tree_step_check), and the verify ticks' device split from a traced
        # oracle wave beside the plain wave's.
        spec_refs = {False: {r.uid: r.tokens for r in plain_rep.results},
                     True: {r.uid: r.tokens for r in q8_rep.results}}
        spec_kw = dict(slots=8, cache_len=640, prefill_chunk=256, kv_block=64)
        t0 = time.monotonic()
        with shared_weights():
            spec = spec_phase(dev, params, tcfg, SERVE_ARGS, trace, spec_refs,
                              spec_kw, wrappers, reset_counts, TOL_LOGITS)
        for label, r in spec["cli"].items():
            if "kv_quant none" in label:
                same = sum(a == b for uid, toks in r["tokens"].items()
                           for a, b in zip(toks, single_tokens[uid]))
                r["tokens_equal_to_nonspec"] = same / (16 * 64)
                print(f"spec serve ({label}): {same} of {16 * 64} greedy tokens "
                      f"equal the non-speculative serve's (reported, not gated); "
                      f"{r['tokens_per_sec']:.1f} spec tok/s beside "
                      f"{rec['tokens_per_sec']} non-spec tok/s", flush=True)
            del r["tokens"]
        tree_step = tree_step_check(params, tcfg, dev)
        print(f"tree verify step: kernel vs plain logits |d| "
              f"{tree_step['logits_err_plain']:.3e} (int8 "
              f"{tree_step['int8_logits_err_plain']:.3e}), tree rows vs their "
              f"root paths decoded token by token |d| "
              f"{tree_step['logits_err_paths']:.3e} (tol {TOL_LOGITS})",
              flush=True)
        if not all(math.isfinite(e) and e <= TOL_LOGITS
                   for e in tree_step.values()):
            fail(f"tree verify step: {tree_step}")
        # The multi-row body's kernels by name (their template arguments lead
        # with the operands): B1 <0, false, ...>, B2 <0, true, ...>, B4 <1,
        # false, ...>, B5 <1, true, ...> or <2, ...>, the cast route <3 or 4,
        # ...>.
        spec_wave, spec_breakdown = wave_breakdown("spec serve (oracle)", {
            "B2 multi-row body (tree and chain verify ticks, tails)": (
                "decode_tiled",),
            "B2 tick body (decode ticks)": ("decode_tick",),
            "flash_decode (B2/B1 split body) + merges": ("decode_split",
                                                         "merge_splits"),
            "flash_fwd (B3)": ("flash_fwd",), "matmul": matmul},
            speculate=True, draft_k=4,
            drafter=oracle_drafter(trace, spec_refs[False], tcfg.vocab_size))
        spec_breakdown["spec"] = spec_wave.spec
        spec_breakdown["nonspec_tokens_per_sec"] = plain_rep.tokens_per_sec
        spec_breakdown["verify_ticks"] = spec_wave.decode_ticks
        print(f"spec wave (oracle, 8 requests): {spec_wave.tokens_per_sec:.1f} "
              f"tok/s beside the plain wave's {plain_rep.tokens_per_sec:.1f}; "
              f"{spec_wave.decode_ticks} verify ticks vs "
              f"{plain_rep.decode_ticks} decode ticks; spec "
              f"{json.dumps(spec_wave.spec)}; phase wall "
              f"{time.monotonic() - t0:.2f}s", flush=True)
        # The same oracle wave on the paged int8 pool: B5's verify ticks on the
        # multi-row body, B1's staged prompt tails, B5's tick body on the
        # decode ticks between.
        spec8_wave, spec8_breakdown = wave_breakdown(
            "spec serve (oracle, paged int8)", {
                "B5 multi-row body (verify ticks)": ("decode_tiled_kernel<1,",
                                                     "decode_tiled_kernel<2,"),
                "B1 multi-row body (staged prompt tails)": (
                    "decode_tiled_kernel<0, false",),
                "B5 tick body (decode ticks)": ("decode_tick",),
                "decode split body (B1) + merges": ("decode_split",
                                                    "merge_splits"),
                "flash_fwd (B3)": ("flash_fwd",), "matmul": matmul},
            speculate=True, draft_k=4, quantize=True,
            drafter=oracle_drafter(trace, spec_refs[True], tcfg.vocab_size))
        spec8_breakdown["spec"] = spec8_wave.spec
        spec8_breakdown["verify_ticks"] = spec8_wave.decode_ticks
        # ... and on the contiguous int8 cache: B4's verify ticks on the
        # multi-row body.
        specc8_wave, specc8_breakdown = wave_breakdown(
            "spec serve (oracle, contiguous int8)", {
                "B4 multi-row body (verify ticks)": (
                    "decode_tiled_kernel<1, false",),
                "B1 multi-row body (staged prompt tails)": (
                    "decode_tiled_kernel<0, false",),
                "decode split body (B4 ticks, B1) + merges": ("decode_split",
                                                              "merge_splits"),
                "flash_fwd (B3)": ("flash_fwd",), "matmul": matmul},
            speculate=True, draft_k=4, quantize=True, kv_layout="contiguous",
            drafter=oracle_drafter(trace, spec_refs[True], tcfg.vocab_size))
        specc8_breakdown["spec"] = specc8_wave.spec
        specc8_breakdown["verify_ticks"] = specc8_wave.decode_ticks
        del server, params
        torch.cuda.empty_cache()

    if "3f" in run:
        mark("3f")
        # -- 3f. the radix prefix cache ---------------------------------------
        # The serve phase's trace with a shared 384-token prefix, through the
        # CLI's --prefix-cache on the paged layout (exact, int8, int8-cast) and
        # the contiguous one, each beside the cache-off serve (prefix_phase).
        t0 = time.monotonic()
        with shared_weights():
            prefix = prefix_phase(
                dev, smi, SERVE_ARGS, wrappers, reset_counts, TOL_LOGITS,
                split_by, {
                    "B2 tick body (decode ticks)": ("decode_tick",),
                    "B2 multi-row body (tails, suffix chunks)": (
                        "decode_tiled",),
                    "flash_decode (split body) + merges": (
                        "decode_split", "merge_splits"),
                    "flash_fwd (B3)": ("flash_fwd",),
                    "matmul": matmul})
        print(f"prefix phase wall {time.monotonic() - t0:.2f}s", flush=True)
        torch.cuda.empty_cache()

    if "3c" in run:
        mark("3c")
        # -- 3c. two ranks sharing the card: the sequence-sharded pool ---------
        sharded = run_sharded_ranks()
        sh = {label: [r[label] for r in sharded] for label in ("exact", "int8")}
        for label, ranks in sh.items():
            for rank, r in enumerate(ranks):
                rrec, n_steps = r["rec"], r["rec"]["steps"]
                n_att = n_layers * n_steps
                want_colls = {"paged_tree_decode/pmax": n_att,
                              "paged_tree_decode/psum_num": n_att,
                              "paged_tree_decode/psum_den": n_att}
                if label == "int8":
                    want_colls["paged_anchor_scales/psum"] = n_steps
                print(f"sharded serve ({label}), rank {rank} of 2 on one card "
                      f"over gloo: {rrec['requests']} requests, "
                      f"{rrec['tokens_generated']} tokens, {rrec['tokens_per_sec']}"
                      f" tok/s (two ranks sharing one card, not a scaling "
                      f"figure), steps {n_steps}, launches "
                      f"{json.dumps(r['launches'])}, collectives "
                      f"{json.dumps(r['colls'])}, pool bytes {r['pool_bytes']} "
                      f"of {r['whole_pool_bytes']}, wall {r['wall_s']:.2f}s",
                      flush=True)
                if rrec["outcomes"] != {"budget": 16} or \
                        rrec["tokens_generated"] != 16 * 64:
                    fail(f"sharded serve ({label}) rank {rank}: outcomes "
                         f"{rrec['outcomes']}, {rrec['tokens_generated']} tokens")
                if any(rrec["leaks"][k] for k in rrec["leaks"]):
                    fail(f"sharded serve ({label}) rank {rank} leaked: "
                         f"{rrec['leaks']}")
                if 2 * r["pool_bytes"] != r["whole_pool_bytes"]:
                    fail(f"sharded serve ({label}) rank {rank}: pool bytes "
                         f"{r['pool_bytes']}, not half of {r['whole_pool_bytes']}")
                # B2 local_blocks once per layer and step; nothing else attends
                # over the sharded pool (int8: B1/B3 run the staged chunks on
                # the whole staging cache).
                lc = r["launches"]
                if not (n_steps > 0 and lc["flash_decode_paged_local"] == n_att
                        and lc["flash_decode_paged"] == 0
                        and lc["flash_decode_paged_q8q"] == 0):
                    fail(f"sharded serve ({label}) rank {rank}: launches {lc} "
                         f"over {n_steps} steps")
                if label == "exact" and lc["flash_fwd"]:
                    fail(f"sharded serve (exact) rank {rank} ran B3: {lc}")
                # bf16 chunks (more than one packed row) take B2's multi-row
                # body; the int8 slice sees one-row decode ticks only (staged
                # admission runs the chunks on the staging cache).
                if (lc["flash_decode_paged_tiled"] > 0) != (label == "exact"):
                    fail(f"sharded serve ({label}) rank {rank}: multi-row B2 "
                         f"launches {lc['flash_decode_paged_tiled']}")
                # ... and its one-row ticks all on the tick body.
                if not (lc["flash_decode_paged_tick"] > 0
                        and lc["flash_decode_paged_local"]
                        == lc["flash_decode_paged_tick"]
                        + lc["flash_decode_paged_tiled"]):
                    fail(f"sharded serve ({label}) rank {rank}: ticks off the "
                         f"tick body: {lc}")
                if r["colls"] != want_colls:
                    fail(f"sharded serve ({label}) rank {rank}: collectives "
                         f"{r['colls']}, expected {want_colls}")
            if ranks[0]["tokens"] != ranks[1]["tokens"]:
                fail(f"sharded serve ({label}): the ranks' tokens differ")
        sh_family = [r["family"] for r in sharded]
        for rank, f in enumerate(sh_family):
            twin_same = [sum(a == b for a, b in zip(f["branches"][i], t))
                         for i in (0, 1) for t in f["twins"]]
            print(f"sharded fork family ({smi}), rank {rank} of 2 on one card "
                  f"over gloo: prompt {f['prompt_len']} tokens, n=2, forks "
                  f"{f['kv']['forks']}, blocks shared "
                  f"{f['kv']['fork_blocks_shared']}, tail-copy SUMs "
                  f"{f['fork_copy_sums']}; tokens of branch 0 and 1 equal to "
                  f"the two independent twins' {twin_same} of {f['n_new']} "
                  f"(reported: two identical requests on the sharded pool part "
                  f"on near-ties, their blocks split over the ranks "
                  f"otherwise), leaks {f['leaks']}", flush=True)
            if not (sorted(f["branches"]) == [0, 1] and f["kv"]["forks"] == 1
                    and all(len(b) == f["n_new"]
                            for b in f["branches"].values())
                    and leaks_clean(f["leaks"])
                    and f["leaks"]["blocks_shared"] == 0):
                fail(f"sharded fork family, rank {rank}: {f}")
        if sh_family[0]["branches"] != sh_family[1]["branches"] \
                or sh_family[0]["fork_copy_sums"] \
                != sh_family[1]["fork_copy_sums"]:
            fail("sharded fork family: the ranks' branches or copies differ")
        single_fam = sh_family[0]["single"]
        fam_same = sum(a == b for i in (0, 1) for a, b in zip(
            sh_family[0]["branches"][i], single_fam[i]))
        fam_margin = sh_family[0]["replay_margin"]
        print(f"sharded fork family: {fam_same} of "
              f"{sum(len(t) for t in single_fam.values())} greedy tokens equal "
              f"the single-rank family's (branches equal: "
              f"{sh_family[0]['branches'] == single_fam}; reported, as the "
              f"sharded serve's agreement is); every branch and twin token "
              f"within {fam_margin:.3e} of its position's largest logit on the "
              f"single-rank kernel path (tol {TOL_LOGITS})", flush=True)
        if not (math.isfinite(fam_margin) and fam_margin <= TOL_LOGITS):
            fail(f"sharded fork family: replay margin {fam_margin}")
        if "3" in run and sh["exact"][0]["whole_pool_bytes"] \
                != single_pool_bytes:
            fail(f"sharded serve: whole pool {sh['exact'][0]['whole_pool_bytes']}"
                 f" B vs the single-rank serve's {single_pool_bytes} B")
        for rank, r in enumerate(sharded):
            m = r["mixed"]
            print(f"sharded mixed step, rank {rank}: merged logits vs the "
                  f"single-rank path on the same logical cache |d| "
                  f"{m['logits_err']:.3e} (tol {TOL_LOGITS})", flush=True)
            if not (math.isfinite(m["logits_err"])
                    and m["logits_err"] <= TOL_LOGITS):
                fail(f"sharded mixed step, rank {rank}: logits differ by "
                     f"{m['logits_err']}")
        if "3" in run:
            same = sum(a == b for uid, toks in sh["exact"][0]["tokens"].items()
                       for a, b in zip(toks, single_tokens[uid]))
            sharded_agree = same / (16 * 64)
            print(f"sharded serve: {same} of {16 * 64} greedy tokens equal the "
                  f"single-rank exact serve's ({sharded_agree:.4f}; reported, "
                  f"not gated)", flush=True)
        mdec = sharded[0]["decode"]
        floor_ms = mdec["kv_bytes"] / HBM_BYTES_PER_S * 1e3
        print(f"decode on two ranks sharing one card (gloo; two ranks sharing "
              f"one card, not a scaling figure): {mdec['name']} "
              f"{mdec['median_s'] * 1e3:.4f} ms per step ({mdec['clock']}; this "
              f"rank's KV floor {floor_ms:.4f} ms), B1 launches "
              f"{[r['decode_launches'] for r in sharded]}", flush=True)
        if mdec["name"] != "tree_decode" or not all(
                r["decode_launches"] for r in sharded) \
                or mdec["median_s"] * 1e3 < floor_ms:
            fail(f"decode on the mesh: {mdec['name']}, launches "
                 f"{[r['decode_launches'] for r in sharded]}, median "
                 f"{mdec['median_s']} s")

    if "3e" in run:
        mark("3e")
        # -- 3e. two ranks sharing the card: sequence-parallel training -------
        from tree_attention_tpu_torch.parallel import tree as ttree

        margs = parse_args(TRAIN_MESH_ARGS)
        m_layers = margs.n_layers
        m_steps = margs.steps + 1 + margs.iters  # --steps, warmup, --iters
        B_t, H_t, T_t, D_t = TREE_SHAPE
        if ttree.gather_chunk(None, batch=B_t, heads=H_t, head_dim=D_t,
                              itemsize=2, n_shards=2, tq_local=T_t // 2) \
                != T_t // 2:
            fail("tree_attention gathers the training shape in more than one "
                 "chunk; tree_runs counts one")
        trained = run_train_ranks()
        for rank, r in enumerate(trained):
            for layout in LAYOUTS:
                t = r["tree"][layout]
                print(f"tree_attention ({layout}, B{B_t} H{H_t} T{T_t} "
                      f"D{D_t} causal), rank {rank} of 2 on one card over gloo:"
                      f" out relative {t['fwd'][2]:.3e}, |dlse| "
                      f"{t['fwd'][3]:.3e} (tol {TOL_OUT_REL}/{TOL_LSE}); "
                      f"dq/dk/dv relative {t['bwd'][2]:.3e} (tol "
                      f"{TOL_GRAD_REL}; the row gate alone "
                      f"{t['bwd_row_gate_alone'][2]:.3e}, the merge's rounding "
                      f"allowance a median "
                      f"{max(t['allowance_over_row_tol']):.3f} of the row "
                      f"tolerance; worst row against f32, dq/dk/dv: sharded "
                      f"{[round(x, 5) for x in t['vs_f32']['sharded']]}, "
                      f"unsharded "
                      f"{[round(x, 5) for x in t['vs_f32']['unsharded']]}); "
                      f"forward + backward "
                      f"{t['fwd_bwd_ms']:.2f} ms (host clock; two ranks "
                      f"sharing one card, not a scaling figure); planted: "
                      f"previous rank's slice -> relative "
                      f"{t['wrong_slice'][2]:.3e}, dlse dropped -> relative "
                      f"{t['dlse_dropped'][2]:.3e}; both rejected: "
                      f"{not (t['wrong_slice'][0] or t['dlse_dropped'][0])}",
                      flush=True)
                if not (t["fwd"][0] and t["bwd"][0]):
                    fail(f"tree_attention ({layout}) rank {rank} differs from "
                         f"unsharded B3/B6/B7: {t['fwd']} {t['bwd']}")
                if t["wrong_slice"][0] or t["dlse_dropped"][0]:
                    fail(f"tree_attention ({layout}) rank {rank}: the gates "
                         f"accept a planted fault")
        per_step = {"tree_attention/all_gather": 3 * m_layers,
                    "tree_attention/pmax": 2 * m_layers,
                    "tree_attention/psum_scatter": 3 * m_layers,
                    "train_step/psum_grads": 1}
        for layout in LAYOUTS:
            mrec = trained[0]["train"][layout]["rec"]
            for rank, r in enumerate(trained):
                t = r["train"][layout]
                n = m_layers * m_steps * tree_runs(layout, 2, rank)
                want_l = {"flash_fwd": 2 * n, "flash_dq": n, "flash_dkv": n,
                          "flash_decode": 0, "flash_decode_tiled": 0}
                want_c = {k: c * m_steps for k, c in per_step.items()}
                print(f"sharded train ({layout}), rank {rank} of 2 on one card "
                      f"over gloo: launches {json.dumps(t['launches'])} over "
                      f"{m_steps} steps (expected {json.dumps(want_l)}), "
                      f"collectives {json.dumps(t['colls'])}, wall incl. init "
                      f"{t['wall_s']:.2f}s", flush=True)
                if t["launches"] != want_l:
                    fail(f"sharded train ({layout}) rank {rank}: launches "
                         f"{t['launches']}, expected {want_l}")
                if t["colls"] != want_c:
                    fail(f"sharded train ({layout}) rank {rank}: collectives "
                         f"{t['colls']}, expected {want_c}")
            if layout == "zigzag":
                sp = trained[0]["step_split"]
                print(f"sharded train step (zigzag, rank 0 of 2 on one card; "
                      f"two ranks sharing one card, not a scaling figure): "
                      f"median wall {sp['step_wall_ms']:.2f} ms of "
                      f"{[round(w, 2) for w in sp['step_walls_ms']]}; rank 0's "
                      f"device time " + (json.dumps(
                          {k: round(v, 3) for k, v in sp["by_group_ms"].items()})
                          + f", busy {sp['busy_ms']:.2f} ms, idle share "
                          f"{sp['idle_share']:.4f}" if sp.get("busy_ms")
                          else "not measured"), flush=True)
            print(f"sharded train ({layout}): losses {mrec['losses']}, step "
                  f"median {mrec['median_s'] * 1e3:.2f} ms ({mrec['clock']}), "
                  f"{mrec['tokens_per_sec']} tok/s (two ranks sharing one card, "
                  f"not a scaling figure), parameters equal across ranks "
                  f"{mrec['params_equal_across_ranks']}", flush=True)
            if not (len(mrec["losses"]) == margs.steps
                    and all(math.isfinite(x) for x in mrec["losses"])):
                fail(f"sharded train ({layout}) losses {mrec['losses']}")
            if mrec["params_equal_across_ranks"] is not True \
                    or mrec["collectives_per_step"] != per_step \
                    or mrec["seq_layout"] != layout:
                fail(f"sharded train ({layout}) record: {mrec}")
        torch.cuda.empty_cache()

    if "4" in run:
        mark("4")
        # -- 4. decode: the reference workload through B1, then int8 through
        # B4 and through B1 over int8 K/V ---------------------------------------
        decode_recs = {}
        for quant, kernel in (("none", "flash_decode"),
                              ("int8", "flash_decode_q8q"),
                              ("int8-cast", "flash_decode")):
            reset_counts()
            drec = cli.run_decode(parse_args(
                ["--mode", "decode", "--iters", "20", "--kv-quant", quant]), dev)
            n = wrappers[kernel].launches
            floor_ms = drec["kv_bytes"] / HBM_BYTES_PER_S * 1e3
            drec["launches"] = n
            decode_recs[quant] = drec
            print(f"decode ({drec['name']}, kv_quant {quant}): "
                  f"{drec['median_s'] * 1e3:.4f} ms per step ({drec['clock']}; "
                  f"KV floor {floor_ms:.4f} ms), {drec['tokens_per_sec']} KV "
                  f"tokens/s, {kernel} launches {n}", flush=True)
            if n == 0:
                fail(f"decode --kv-quant {quant} never launched {kernel}")
            if drec["median_s"] * 1e3 < floor_ms:
                fail(f"decode --kv-quant {quant}: {drec['median_s']} s is below "
                     f"the KV bytes' floor {floor_ms} ms")
        drec = decode_recs["none"]
        if "3" in run:
            launches["flash_decode"] = decode_recs["none"]["launches"]

    if "5" in run:
        mark("5")
        # -- 5. train through the CLI's --mode train ---------------------------
        targs = parse_args(TRAIN_ARGS)
        n_layers = targs.n_layers
        # Steps the run takes: --steps, then the timing's warmup and --iters.
        steps_run = targs.steps + 1 + targs.iters
        reset_counts()
        buf = io.StringIO()
        t0 = time.monotonic()
        with contextlib.redirect_stdout(buf):
            cli.main(TRAIN_ARGS)
        torch.cuda.synchronize()
        train_wall = time.monotonic() - t0
        trec = json.loads(buf.getvalue().strip().splitlines()[-1])
        train_launches = {n: wrappers[n].launches
                          for n in ("flash_fwd", "flash_dq", "flash_dkv")}
        print(f"train: losses {trec['losses']}, {trec['tokens_per_sec']} tok/s, "
              f"step median {trec['median_s'] * 1e3:.2f} ms ({trec['clock']}), "
              f"launches {json.dumps(train_launches)} over {steps_run} steps, "
              f"wall incl. init {train_wall:.2f}s", flush=True)
        if not (len(trec["losses"]) == targs.steps
                and all(math.isfinite(x) for x in trec["losses"])):
            fail(f"train losses {trec['losses']}")
        # B6 and B7 once per layer per backward; B3 twice per layer per step
        # (the forward, and its recomputation under remat in the backward).
        expect = {"flash_fwd": 2 * n_layers * steps_run,
                  "flash_dq": n_layers * steps_run,
                  "flash_dkv": n_layers * steps_run}
        if train_launches != expect:
            fail(f"train launches {train_launches}, expected {expect}")
        # The two-rank runs' first loss (same seed, parameters and batch).
        if "3e" in run:
            first = {layout: trained[0]["train"][layout]["rec"]["losses"][0]
                     for layout in LAYOUTS}
            print(f"sharded train first loss vs single rank "
                  f"{trec['losses'][0]:.6f}: {json.dumps(first)} (tol "
                  f"{TOL_STEP_LOSS})", flush=True)
            if not all(abs(x - trec["losses"][0]) <= TOL_STEP_LOSS
                       for x in first.values()):
                fail(f"sharded train first loss {first} vs single rank "
                     f"{trec['losses'][0]}")

    if "6" in run:
        mark("6")
        # -- 6. one training step, kernel path against plain path --------------
        from tree_attention_tpu_torch.data import make_lm_batch
        from tree_attention_tpu_torch.models import (
            default_optimizer,
            init_params,
            init_train_state,
            loss_and_grads,
            make_train_step,
            named_params,
        )

        tcfg = cli.transformer_config(targs)
        batch = make_lm_batch(torch.Generator().manual_seed(5), targs.batch,
                              targs.seq_len, tcfg.vocab_size, dev)
        one = {}
        for impl in ("auto", "plain"):
            c = dataclasses.replace(tcfg, n_layers=2, attn_impl=impl)
            p = init_params(c, 0, dev)
            for _, t in named_params(p):
                t.requires_grad_(True)
            loss, grads = loss_and_grads(p, batch, c)
            one[impl] = (float(loss), grads)
            del p
        (loss_k, g_k), (loss_p, g_p) = one["auto"], one["plain"]
        grad_rel = {n: ((g_k[n].float() - g_p[n].float()).norm()
                        / g_p[n].float().norm().clamp_min(1e-30)).item()
                    for n in g_p}
        worst = max(grad_rel, key=grad_rel.get)
        print(f"train step, kernels vs plain (2 layers): loss {loss_k:.6f} vs "
              f"{loss_p:.6f} (tol {TOL_STEP_LOSS}); worst gradient "
              f"{worst} |dg|/|g| {grad_rel[worst]:.3e} (tol {TOL_STEP_GRAD})",
              flush=True)
        if not abs(loss_k - loss_p) <= TOL_STEP_LOSS:
            fail(f"kernel-path loss {loss_k} vs plain {loss_p}")
        if not all(r <= TOL_STEP_GRAD for r in grad_rel.values()):
            fail(f"kernel-path gradients differ: {grad_rel}")
        del one, g_k, g_p
        torch.cuda.empty_cache()

    if "7" in run:
        mark("7")
        # -- 7. where a training step's time goes ------------------------------
        # Three untraced steps (the median wall) and one traced step (its device
        # time) at the train phase's config, after a warm-up step.
        opt = default_optimizer()
        state = init_train_state(tcfg, opt, seed=0, device=dev)
        step = make_train_step(tcfg, opt)
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):  # one wall is at the host's mercy: take the median
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        step_wall_ms = sorted(walls)[1]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            traced_wall_ms = (time.perf_counter() - t0) * 1e3
        tsplit, tby_kernel = split_by(prof, {
            "flash_fwd (B3)": ("flash_fwd",), "flash_dq (B6)": ("flash_dq",),
            "flash_dkv (B7)": ("flash_dkv",), "matmul": matmul})
        tbusy = sum(tsplit.values())
        train_breakdown = {
            "step_wall_ms": step_wall_ms,
            "step_walls_ms": walls,
            "peak_memory_gb": peak_gb,
            "traced_step_wall_ms": traced_wall_ms,
            "device_busy_ms": tbusy,
            "idle_share": (1 - tbusy / step_wall_ms) if tbusy else None,
            "by_group_ms": tsplit,
            "top_kernels_ms": dict(sorted(tby_kernel.items(),
                                          key=lambda kv: -kv[1])[:12]),
        }
        print("train step breakdown: "
              + (json.dumps({k: round(v, 3) for k, v in tsplit.items()})
                 + f" busy {tbusy:.2f} ms (traced) of {step_wall_ms:.2f} ms "
                 f"median untraced step wall (of {[round(w, 2) for w in walls]}; "
                 f"{traced_wall_ms:.2f} ms traced), idle "
                 f"share {train_breakdown['idle_share']:.4f}, peak device "
                 f"memory {peak_gb:.2f} GB"
                 if tbusy else "device time not measured"), flush=True)
        del state, step, batch
        torch.cuda.empty_cache()

    if "3g" in run:
        mark("3g")
        # -- 3g. live HTTP serving --------------------------------------------
        # The serve phase's engine behind the HTTP ingress, exact then int8:
        # SSE and whole-body clients, a disconnect, deadlines, 429s, a drain.
        with shared_weights():
            ingress = ingress_phase(dev, smi, SERVE_ARGS, wrappers,
                                    reset_counts, TOL_LOGITS)
        torch.cuda.empty_cache()

    if "3h" in run:
        mark("3h")
        # -- 3h. whole-prompt admission and the host-RAM KV tier ---------------
        t0 = time.monotonic()
        whole_tier = whole_tier_phase(
            dev, smi, SERVE_ARGS, wrappers, reset_counts, TOL_LOGITS,
            split_by=split_by, groups={
                "B2 tick body (decode ticks)": ("decode_tick",),
                "B2 multi-row body": ("decode_tiled",),
                "flash_decode (split body) + merges": ("decode_split",
                                                       "merge_splits"),
                "flash_fwd (B3)": ("flash_fwd",),
                "matmul": matmul})
        print(f"whole/tier phase wall {time.monotonic() - t0:.2f}s", flush=True)
        torch.cuda.empty_cache()

    if "3i" in run:
        mark("3i")
        # -- 3i. copy-on-write fork families ----------------------------------
        forks = fork_phase(dev, smi, SERVE_ARGS, wrappers, reset_counts,
                           TOL_LOGITS)
        torch.cuda.empty_cache()

    if "3j" in run:
        mark("3j")
        # -- 3j. token-tree sibling families ----------------------------------
        trees = tree_phase(dev, smi, SERVE_ARGS, wrappers, reset_counts,
                           TOL_LOGITS)
        torch.cuda.empty_cache()

    if "3k" in run:
        mark("3k")
        # -- 3k. disaggregated prefill/decode ---------------------------------
        disagg = disagg_phase(dev, smi, SERVE_ARGS, wrappers, reset_counts,
                              TOL_LOGITS)
        torch.cuda.empty_cache()

    if "3l" in run:
        mark("3l")
        # -- 3l. the in-process fleet and the request ledger --------------------
        with shared_weights():
            fleet = fleet_phase(dev, smi, SERVE_ARGS, wrappers, reset_counts,
                                TOL_LOGITS)
        torch.cuda.empty_cache()

    mark(None)

    if run != set(PHASES):
        # A partial run has no whole kernels line: its phases' own lines
        # above carry their gates and numbers.
        print(f"chip_smoke: total wall {time.monotonic() - t_start:.1f}s",
              flush=True)
        print(json.dumps({"phases": [p for p in PHASES if p in run]}),
              flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        }}), flush=True)
        return

    # -- 8. report -------------------------------------------------------
    csrc = "tree_attention_tpu_torch/csrc/"
    meta = {
        "flash_decode": ("cuda", csrc + "flash_decode.cu",
                         "tree_attention_tpu/ops/pallas_decode.py:179"),
        "flash_decode_paged_tick": (
            "cuda", csrc + "decode_tick.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_q8q": ("cuda", csrc + "flash_decode.cu",
                             "tree_attention_tpu/ops/pallas_decode.py:266"),
        "flash_decode_paged_q8q_tick": (
            "cuda", csrc + "decode_tick.cu",
            "tree_attention_tpu/ops/pallas_decode.py:461"),
        "flash_decode_paged_local_tick": (
            "cuda", csrc + "decode_tick.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_paged_local_tiled": (
            "cuda", csrc + "flash_decode_tiled.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_paged_tiled": (
            "cuda", csrc + "flash_decode_tiled.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_tiled": (
            "cuda", csrc + "flash_decode_tiled.cu",
            "tree_attention_tpu/ops/pallas_decode.py:179"),
        "flash_decode_paged_q8q_tiled": (
            "cuda", csrc + "flash_decode_tiled_q8q.cu",
            "tree_attention_tpu/ops/pallas_decode.py:461"),
        "flash_decode_q8q_tiled": (
            "cuda", csrc + "flash_decode_tiled_q8q.cu",
            "tree_attention_tpu/ops/pallas_decode.py:266"),
        "flash_decode_cast_tiled": (
            "cuda", csrc + "flash_decode_tiled_cast.cu",
            "tree_attention_tpu/ops/pallas_decode.py:179"),
        "flash_decode_paged_cast_tiled": (
            "cuda", csrc + "flash_decode_tiled_cast.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_tree": ("cuda", csrc + "flash_decode_tiled.cu",
                              "tree_attention_tpu/ops/pallas_decode.py:179"),
        "flash_decode_paged_tree": (
            "cuda", csrc + "flash_decode_tiled.cu",
            "tree_attention_tpu/ops/pallas_decode.py:344"),
        "flash_decode_q8q_tree": (
            "cuda", csrc + "flash_decode_tiled_q8q.cu",
            "tree_attention_tpu/ops/pallas_decode.py:266"),
        "flash_decode_paged_q8q_tree": (
            "cuda", csrc + "flash_decode_tiled_q8q.cu",
            "tree_attention_tpu/ops/pallas_decode.py:461"),
        "flash_fwd": ("cuda", csrc + "flash_fwd.cu",
                      "tree_attention_tpu/ops/pallas_attention.py:65"),
        "flash_dq": ("cuda", csrc + "flash_bwd.cu",
                     "tree_attention_tpu/ops/pallas_bwd.py:84"),
        "flash_dkv": ("cuda", csrc + "flash_bwd.cu",
                      "tree_attention_tpu/ops/pallas_bwd.py:118"),
    }
    # Main-path launches: B1 in the decode phase, B2's ticks in the serve
    # phase, B3 in the serve and the train phases, B6/B7 in the train
    # phase, B5's ticks in the int8 serve, B4 in the int8 decode and the
    # contiguous int8 serve.
    main_launches = dict(launches)
    for n, count in train_launches.items():
        main_launches[n] = main_launches.get(n, 0) + count
    # ... and rank 0's in the two-rank training runs.
    for n in train_launches:
        main_launches[n] += sum(trained[0]["train"][layout]["launches"][n]
                                for layout in LAYOUTS)
    main_launches["flash_decode_paged_q8q_tick"] = q_launches[
        "flash_decode_paged_q8q_tick"]
    main_launches["flash_decode_q8q"] = (decode_recs["int8"]["launches"]
                                         + c_launches["flash_decode_q8q"])
    # B2 local_blocks: rank 0's launches in the two-rank exact sharded
    # serve, ticks and chunks.
    for name in ("tick", "tiled"):
        main_launches[f"flash_decode_paged_local_{name}"] = sh["exact"][0][
            "launches"][f"flash_decode_paged_{name}"]
    # B2's multi-row body: its launches in the plain serve (prompt tails).
    main_launches["flash_decode_paged_tiled"] = launches[
        "flash_decode_paged_tiled"]
    # B1's multi-row body: the int8 serve's staged prompt tails; B5's and
    # B4's: the verify ticks of the speculative serves over the paged and
    # the contiguous int8 pool; the cast route's (B1, B2): the verify
    # ticks of the q8 oracle serves.
    spec_runs = {**spec["cli"], **spec["oracle"]}
    main_launches["flash_decode_tiled"] = q_launches["flash_decode_tiled"]
    for name, tree_kernel, route in (
            ("flash_decode_paged_q8q_tiled", "flash_decode_paged_q8q",
             "q8q"),
            ("flash_decode_q8q_tiled", "flash_decode_q8q", "q8q"),
            ("flash_decode_cast_tiled", "flash_decode", "q8"),
            ("flash_decode_paged_cast_tiled", "flash_decode_paged", "q8")):
        main_launches[name] = sum(
            r["tiled_launches"] for r in spec_runs.values()
            if r["tree_kernel"] == tree_kernel and r["route"] == route)
        if not main_launches[name]:
            fail(f"the speculative serves never launched {name}")
    # Every serve's multi-row launches by kernel and Tq.
    for label, r in spec_runs.items():
        serve_tiled[f"spec {label}"] = r["tiled_by_tq"]
    # The tree variants: their launches in the speculative serves (3d; the
    # cast route's count under its multi-row entries above).
    for name in ("flash_decode", "flash_decode_paged", "flash_decode_q8q",
                 "flash_decode_paged_q8q"):
        main_launches[name + "_tree"] = sum(
            r["tree_launches"] for r in spec_runs.values()
            if r["tree_kernel"] == name and r["route"] != "q8")
        if not main_launches[name + "_tree"]:
            fail(f"the speculative serves never launched {name}'s tree "
                 f"variant")
    # Phase 3j's tree families and phase 3k's disaggregated serves: their
    # own counts (set to 0 before each serve, read after it).
    tree_launches = {f"tree families greedy {q}": trees[f"a_{q}"]["launches"]
                     for q in ("exact", "int8")}
    tree_launches["n=8 on one slot"] = trees["b"]["launches"]
    disagg_launches = {f"disagg {q}": disagg["runs"][q]["launches"]
                       for q in ("exact", "int8")}
    fork_launches = {
        "family n=2 (4 requests)": forks["a"]["launches"]["family"],
        "independent twins (8 requests)": forks["a"]["launches"][
            "independent"],
        "int8 family n=2 (2 requests)": forks["b"]["launches"],
        "HTTP n=3": forks["d"]["http_launches"]}
    kernels = []
    for name, (route, src, replaces) in meta.items():
        mine = [c for c in cases if c["kernel"] == name]
        gated = [c for c in mine if c["max_abs_err"] is not None]
        head = mine[0]  # the main-path shape: listed first per kernel
        entry = {
            "name": name, "route": route, "source": src,
            "replaces": replaces, "launches": main_launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in gated),
            "max_rel_err": max(c["max_rel_err"] for c in gated),
            "tolerance_rel": (TOL_GRAD_REL if name in ("flash_dq",
                                                       "flash_dkv")
                              else TOL_OUT_REL),
            "parity": "pass",
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
        }
        if name not in ("flash_dq", "flash_dkv"):
            entry["tolerance_lse"] = TOL_LSE
        if head["library_ms"] is None:
            # No PyTorch call computes int8-KV attention.
            entry["library"] = "none"
            entry["yardstick_sdpa_dequant_ms"] = head[
                "yardstick_sdpa_dequant_ms"]
        if head.get("call_ms") is not None:
            entry["call_ms"] = head["call_ms"]
        if name in ("flash_decode", "flash_decode_paged_tick"):
            # The int8-cast route through this kernel.
            cast = next(c for c in mine if c["case"].startswith("int8"))
            entry["int8_cast"] = {k: cast[k] for k in (
                "case", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "yardstick_sdpa_dequant_ms", "max_rel_err")}
            entry["launches_int8"] = (
                decode_recs["int8-cast"]["launches"] if name == "flash_decode"
                else x_launches[name])
            entry["launches_int8_serve_staged"] = q_launches[
                name.replace("_tick", "")]
        if name in ("flash_decode_tree", "flash_decode_paged_tree"):
            # The int8-cast route through the tree variant.
            cast = next(c for c in mine if c["case"].startswith("int8"))
            entry["int8_cast"] = {k: cast[k] for k in (
                "case", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
                "yardstick_sdpa_dequant_ms", "max_rel_err")}
        if name.endswith("_tree"):
            entry["launches_per_run"] = {
                label: r["tree_launches"] for label, r in spec_runs.items()
                if r["tree_kernel"] + "_tree" == name and r["route"] != "q8"}
        if name.startswith("flash_decode_paged_local"):
            # Each rank's ticks (chunks) in the two-rank serves.
            counter = name.replace("_local", "")
            entry["launches_per_rank"] = {
                label: [r["launches"][counter] for r in ranks]
                for label, ranks in sh.items()}
            entry["int8_block_scales"] = next(
                {k: c[k] for k in ("case", "ms", "call_ms", "plain_ms",
                                   "bound_ms", "bound_by",
                                   "yardstick_sdpa_dequant_ms",
                                   "max_rel_err")}
                for c in mine if " int8 " in c["case"])
        # The prefix phase's launches of this kernel, by serve (its own
        # counts: set to 0 before each serve, read after it).
        by_serve = {label: r["launches"][name]
                    for label, r in prefix["serves"].items()
                    if r["launches"].get(name)}
        if by_serve:
            entry["launches_prefix_serves"] = by_serve
        # The ingress phase's launches of this kernel (its own counts, set
        # to 0 before each ingress starts, read after its drain).
        by_ingress = {label: ingress[label]["launches"][name]
                      for label in ("exact", "int8")
                      if ingress[label]["launches"].get(name)}
        if by_ingress:
            entry["launches_ingress"] = by_ingress
        # Phase 3h's launches of this kernel: the whole-admission serves,
        # and the tiered serves' passes (its own counts, set to 0 before
        # each serve or pass, read after it).
        by_whole = {label: r["launches"][name]
                    for label, r in whole_tier["whole"].items()
                    if r["launches"].get(name)}
        if by_whole:
            entry["launches_whole"] = by_whole
        by_tier = {f"{label} pass {i + 1}": n[name]
                   for label in ("exact", "int8")
                   for i, n in enumerate(whole_tier["tier"][label][
                       "launches"]) if n.get(name)}
        if by_tier:
            entry["launches_tiered"] = by_tier
        # Phase 3i's launches of this kernel: the fork serves (its own
        # counts, set to 0 before each serve, read after it).
        by_fork = {label: n[name] for label, n in fork_launches.items()
                   if n.get(name)}
        if by_fork:
            entry["launches_fork"] = by_fork
        by_tree = {label: n[name] for label, n in tree_launches.items()
                   if n.get(name)}
        if by_tree:
            entry["launches_tree_families"] = by_tree
        if name in ("flash_decode_paged_tree", "flash_decode_paged_q8q_tree"):
            q = "int8" if "q8q" in name else "exact"
            entry["tree_family_ticks"] = trees[f"a_{q}"]["tree_ticks"]
            # Counted by the wrapper where it launches the tree variant.
            entry["tree_family_launches_by_tq"] = trees[f"a_{q}"][
                "tree_launches_by_tq"]
            if not by_tree:
                fail(f"the tree families never launched {name}")
        by_disagg = {label: n[name] for label, n in disagg_launches.items()
                     if n.get(name)}
        if by_disagg:
            entry["launches_disagg"] = by_disagg
        # Phase 3l's launches of this kernel: each fleet replica's
        # sequential pass (its own counts, set to 0 before each request,
        # read after it, summed by the replica that served it).
        by_fleet = {f"{q} {rep}": n[name] for q in ("exact", "int8")
                    for rep, n in fleet[q]["launches"].items()
                    if n.get(name)}
        if by_fleet:
            entry["launches_fleet"] = by_fleet
        if name.startswith("flash_decode"):
            # Which body ran the head case (cuda_decode.decode_body: every
            # variant but f32 with more than one packed row or a tree takes
            # the multi-row one).
            entry["body"] = ("tick" if name.endswith("_tick") else
                             "tiled" if name.endswith(("_tiled", "_tree"))
                             else "split")
        if name in ("flash_decode_tiled", "flash_decode_paged_tiled",
                    "flash_decode_paged_q8q_tiled",
                    "flash_decode_q8q_tiled"):
            # The multi-row body's launches of this kernel on every serve,
            # by Tq.
            key = {"flash_decode_tiled": "B1", "flash_decode_paged_tiled":
                   "B2", "flash_decode_paged_q8q_tiled": "B5",
                   "flash_decode_q8q_tiled": "B4"}[name]
            entry["launches_per_serve_by_tq"] = {
                label: by[key] for label, by in serve_tiled.items()
                if key in by}
            if key in ("B1", "B2"):  # the two-rank serves (B1: staged tails)
                entry["launches_sharded_rank0"] = {
                    label: ranks[0]["launches"][name]
                    for label, ranks in sh.items()}
        if name in ("flash_decode_cast_tiled",
                    "flash_decode_paged_cast_tiled"):
            # The cast route's multi-row launches in each q8 oracle serve.
            entry["launches_per_run"] = {
                label: r["tiled_launches"] for label, r in spec_runs.items()
                if r["route"] == "q8"
                and r["tree_kernel"] == name.replace("_cast_tiled", "")}
        if name.endswith("_tick"):
            # The tick body (decode_tick_kernel): one launch a tick, its
            # cluster size at the head case, and its launches per serve.
            entry["kernel"] = "decode_tick_kernel"
            entry["cluster_at_head"] = cuda_decode.decode_geometry(
                "tick", 1, 8, 16, 640).ctas
            if name == "flash_decode_paged_tick":
                entry["launches_per_serve"] = {
                    "serve (exact)": launches[name],
                    "int8-cast serve": x_launches[name],
                    "int8 serve": q_launches[name]}
            if name == "flash_decode_paged_q8q_tick":
                entry["launches_per_serve"] = {"int8 serve": q_launches[name]}
        if name == "flash_decode_paged_tiled":
            entry["launches_per_serve"] = {
                "serve (prompt-tail ticks)": launches[name],
                "serve by Tq bucket": serve_tiled_tq,
                "speculative serves (paged exact)": {
                    label: r["tiled_launches"]
                    for label, r in spec_runs.items()
                    if r["tree_kernel"] == "flash_decode_paged"
                    and r["route"] is None},
                "sharded serve, rank 0 (exact)": sh["exact"][0]["launches"][
                    name]}
        if name in ("flash_fwd", "flash_dq", "flash_dkv"):
            # bf16 runs the tensor-core body: its HGMMA count in the SASS.
            entry["hgmma_sass"] = sum(c for n, c in hgmma.items()
                                      if f"{name}_wgmma" in n)
        if name == "flash_fwd":
            # Serve chunks, then 2 per layer and training step (forward and
            # its recomputation under remat).
            entry["launches_serve"] = launches[name]
            entry["launches_train"] = train_launches[name]
            # Whole admission's cold prefill: Tq = Tk = the bucket.
            entry["whole_prefill_shapes"] = [
                {k: c[k] for k in ("case", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "library_ms")}
                for c in mine if c["case"].startswith("whole prefill")]
            entry["launches_whole_by_tq_x_tk"] = {
                label: r["b3_tq_x_tk"]
                for label, r in whole_tier["whole"].items()}
        if name in train_launches:
            entry["launches_sharded_train_per_rank"] = {
                layout: [r["train"][layout]["launches"][name]
                         for r in trained] for layout in LAYOUTS}
            entry["train_shape"] = next(
                {k: c[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "library_ms")}
                for c in mine if c["case"].startswith("train"))
        kernels.append(entry)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": smi, "build_s": secs, "cases": cases,
                   "serve": rec, "decode": drec, "decode_q8": {
                       k: decode_recs[k] for k in ("int8", "int8-cast")},
                   "int8_serve": q_rec, "int8_serve_steps": q_steps,
                   "int8_serve_launches": q_launches,
                   "int8_serve_contiguous": c_rec,
                   "int8_cast_serve": x_rec, "int8_cast_serve_launches":
                   x_launches,
                   "int8_serve_breakdown": q8_breakdown,
                   "int8_step_vs_plain": q8_step, "q8_gate_teeth": q8_teeth,
                   "tick_ptxas": kptx, "tick_bits": tick_bits,
                   "tick_teeth": tick_teeth,
                   "mixed_step": {"logits_err": logit_err, "kv_err": kv_err,
                                  "kv_max": kv_max},
                   "serve_breakdown": breakdown, "train": trec,
                   "train_launches": train_launches,
                   "train_step_vs_plain": {"loss": [loss_k, loss_p],
                                           "grad_rel": grad_rel},
                   "train_breakdown": train_breakdown,
                   "local_blocks_merge": local_merge,
                   "local_blocks_teeth": local_teeth,
                   "tree_decode_shards": tree_merge,
                   "tree_variants": tree_teeth, "decode_ptxas": dptx,
                   "tiled_ptxas": tptx, "tiled_gate": tiled_gate,
                   "serve_tiled_tq": serve_tiled_tq,
                   "tree_causal_ms": causal_ms,
                   "spec": spec, "spec_tree_step": tree_step,
                   "spec_breakdown": spec_breakdown,
                   "spec_int8_breakdown": spec8_breakdown,
                   "multi_row_gate": multi_gate,
                   "multi_row_bits": multi_bits,
                   "multi_row_teeth": multi_teeth,
                   "int8_multi_row_gate": int8_gate,
                   "int8_multi_row_bits": int8_bits,
                   "int8_multi_row_teeth": int8_teeth,
                   "spec_contiguous_int8_breakdown": specc8_breakdown,
                   "serve_multi_row_by_tq": serve_tiled,
                   "sharded": [{k: r[k] for k in ("exact", "int8", "mixed",
                                                  "decode", "decode_launches")}
                               for r in sharded],
                   "sharded_tokens_equal_to_single": sharded_agree,
                   "ptxas": ptxas, "hgmma_sass": hgmma, "tile_edges": edges,
                   "one_key_rows": one_key_rows, "dlse_bwd": dlse_bwd,
                   "sharded_train": trained, "prefix": prefix,
                   "ingress": ingress, "whole_tier": whole_tier,
                   "forks": forks, "sharded_family": sh_family,
                   "tree_families": trees, "disagg": {
                       "runs": disagg["runs"], "faults": disagg["faults"],
                       "wall_s": disagg["wall_s"]}, "fleet": fleet,
                   "kernels": kernels}, f, indent=1)
    print(f"chip_smoke: total wall {time.monotonic() - t_start:.1f}s",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
