"""Drive the PyTorch/CUDA port of STEP on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises and the run exits non-zero:

1. env     — the card's name and power limit (nvidia-smi), torch and CUDA
             versions.  No visible GPU is a failure.
2. build   — compile every kernel of ``src/repro_torch/csrc`` (one nvcc per
             source, all at once) and print the build time.
3. kernels — hold each kernel body against its plain PyTorch version on the
             card: the edge shapes of the JAX package's kernel tests and the
             shapes the main path gives each kernel.  fused_topk_scatter and
             both topk_compress bodies must be bit-exact (and the two bodies
             equal to each other); kmeans_assign must give the same
             assignments and dist² within 1e-5 relative.  accumulate_blocked
             must be bit-exact in fp32 (within 3e-2 in bf16), and
             sparse_scatter_add bit-exact on the accumulator's pairs (within
             rtol 1e-5, atol 1e-6 where one row repeats an index), one
             launch per call whatever the number of rows.  Each is
             timed (median of CUDA-event timings of one call) beside its plain
             version, its bound and, where one PyTorch call computes the
             same function, that call; the short ones also by CUDA-graph
             replay, which leaves the host's part of a call out.
             flash_attention (fp32 and bf16) and ssd_scan are held to
             test_kernels.py's tolerances at its shapes and at the shapes
             the LM main path gives them; flash_attention also at the edges
             of its tiling (head dims 20, 80 and 192/128, T > S, a
             decode-shaped T = 1, the qwen3 shape at batch 1); ssd_scan
             also off its tiles (N 12 / P 20, N 13 / P 7), over a chain of
             64 chunks, twice in a row and replayed from a CUDA graph, each
             bit-equal to the eager call; both flash bodies', both
             topk_compress bodies', fused_topk_scatter's, sparse_scatter_add's and
             ssd_scan's -Xptxas -v lines (registers, spills) are printed; the bounds of the fp32
             flash body and of ssd_scan are the 3xTF32 tensor-core ones (the
             fp32 pipes' printed beside them).  The bf16 (wgmma) body is
             timed at the qwen3-1.7b prefill shape beside SDPA in bf16 (a
             row of its own), its bound the flops at 989 TFLOP/s.  Then the
             inputs repro's kernels take off the float32 main path
             (A_INPUTS, C_INPUTS, D_INPUTS; bf16 at the main-path shapes;
             ssd_scan at chunk 256), each held and timed beside its plain
             version; accumulate_blocked's and sparse_scatter_add's
             host cost split into the parts of their launch paths (g_split,
             1,000 calls each; h_split, 200), and topk_compress's at
             logreg's shape (b_split); ssd_scan at mamba2's prefill
             shape in f32 / bf16 at chunks 128 / 256, a call and on the
             device (f_timings); fused_topk_scatter likewise at pagerank's
             and logreg's shapes in f32 / bf16 (a_timings).  flash_attention
             and ssd_scan also at zamba2-2.7b's prefill shapes (MHA at head
             dim 80; N 64), held and timed as at qwen3's and mamba2's
             (check_zamba2_shapes), and flash_attention at the moe
             family's: moonshot-v1-16b-a3b's MHA (16 heads, head dim 128)
             in fp32 and bf16, deepseek-v3-671b's MLA (128 heads, dk 192,
             dv 128) in fp32, SDPA beside it where SDPA takes dk != dv
             (check_moe_shapes; logged, not in the kernels line), and off
             its causal path at the vlm and audio families' shapes:
             llama-3.2-vision-90b's self attention (q (4, 2048, 8, 8, 128),
             causal, G 8) and its cross-attention (the same q over 1,601
             vision keys, non-causal), each in fp32 and bf16 (bf16 also
             against the fp32 plain version at limits scaled to the
             output), hubert-xlarge's MHA
             (q (4, 2048, 16, 1, 80), non-causal), SDPA beside each
             (check_vlm_audio_shapes; logged, not in the kernels line);
             check_flash's edges take the non-causal ones at small sizes;
             and at the dense family's GQA shapes, causal, fp32 and bf16:
             starcoder2-3b's 24 query heads over 2 KV heads (G 12) and
             qwen3-4b's 32 over 8 (G 4), SDPA beside each
             (check_dense_shapes).
4. apps    — the host Session (2 nodes x 2 threads, device left at its
             default) at realistic sizes: pagerank on a LiveJournal-scale
             graph (AUTO, SPARSE fused, SPARSE unfused; before them, each
             thread's slice binned by bin_edges and its credits summed by
             binned_credits, held to pagerank._credits within one fp32 ulp
             and timed beside it, thread 0's slice, with powerlaw_graph's
             hub, the kernels line's pagerank_credits row (check_credits);
             and that slice's fp64 credit scatter timed beside
             sparse_scatter_add in fp32),
             kmeans on the Covertype shape with the kernel (plus four
             uncounted runs from the default init, whose spread is printed),
             logreg with sparse_k fused and unfused; logreg over a CSR x
             (the benchmark's sparse_rows generator, at the cell's
             19,264,097 x 29,890,095 with 566,345,888 nonzeros and at
             200,000 rows of 29 or 30 of 1,000,003 features): thread 0's
             slice of each through the margin kernel and the binned kernel
             with a value an edge, held to their plain versions and timed
             (the cell's slice is the kernels line's logreg_margin row, the
             gradient's numbers beside it), then at the small size a traced
             4-thread AUTO job with its launches and counters asserted, held
             to the CPU's plain path (check_logreg_sparse); nmf's initial
             factors at the nmf cell's 480,189 x 64 and 64 x 17,770 drawn on
             the card and by nmf._init (numpy), bit-equal on three seeds and
             timed beside it, the kernels line's nmf_init row
             (check_nmf_init); nmf's two products over R (R.Q^T, P^T.R) in
             3xTF32 at one thread's slice of the nmf cell (120,047 x 17,770
             from an odd row, rank 64), held to fp64 products and timed by
             CUDA events beside fp32 torch.matmul, the kernels line's
             nmf_products rows (check_nmf_products); nmf on Netflix's 17,770
             movie columns (AUTO and reduce_scatter, each job's draw on the
             card: six nmf_init launches and two nmf_products launches a
             thread and round asserted in every nmf run); one bf16 SPARSE round
             through DAddAccumulator at pagerank's V, fused and unfused,
             bit-exact with its plain path.  Beside the host runs, on the
             same data, the SPMD backend (4 mesh positions as threads on
             the card): pagerank AUTO and SPARSE (the edges trimmed to a
             multiple of 4, and the host runs it is held against given the
             same edges), kmeans with the kernel, logreg SPARSE and nmf
             reduce_scatter, each held to the app tolerance against its host
             run, with the same wire traffic and its launches asserted
             (every pagerank run: a set-up pass a thread, one histogram and
             two scatters, and the credit kernel a thread and round).
             accumulate_blocked is timed per call inside the pagerank AUTO
             run.  Launch counters are
             zeroed just before each run and read just after; every kernel
             must have been launched, the counts each run must give are
             asserted.  A small run of each app is also held against its
             single-thread reference on the CPU.
5. armed   — step.check and step.obs on the card: each app of phase 4 run
             four times on phase 4's data, unarmed, then twice with
             Session(check=True, record=True) (race detector, lock
             sanitizer, spawn-time lint, flight recorder), then unarmed
             again: pagerank AUTO (G; a Watchdog polls it every
             50 ms, and its OpenMetrics page is printed) and SPARSE unfused on
             the trimmed edges (C, H), logreg sparse fused (A) and unfused (B,
             H), logreg sparse through the SPMD backend (B, H), kmeans with
             the kernel (D, plus one launch a thread for the lint's dry run
             of the round body; pagerank likewise its set-up pass and credit
             kernel once a thread) and nmf AUTO (G).  Each armed run must find
             nothing, put the same elements on the wire as the unarmed run,
             agree with it to the app tolerance and launch what the code
             says; both walls and the overhead are printed, and nothing may
             stay armed after.  Then three seeded defects on the card: the
             race demo's lost update (both sites), a barrier-arity lint
             (CheckError before any thread starts), a DBarrier under the
             SPMD backend (spmd-host-sync).  Last,
             scripts/torch_make_report.py's --export-check (four apps armed
             with no finding, the seeded race caught: one read-write and one
             write-write finding) and --export-trace (a traced 2-thread
             logreg fit: 50 spans in four categories) on the card, into
             build/report (report_exports).
6. ft      — the tiered store, live rebalancing and ft/ on the card: (a) a
             4-shard store with a host cold tier and half of its 2,048 x 1 MiB
             fp32 entries (2 GiB) demoted, under 4 writer threads (set then
             get, each read held on the card to the writer's latest value)
             across add_shard(4) driven by migrate_step and remove_shard(1):
             no stale or torn read, the moves those of the port's ring,
             epochs equal to each writer's count of sets, hot + cold bytes
             2 GiB, peak device memory within the hot budgets; the same with
             a disk tier at 256 entries in a temporary directory under
             build/; blocking copy rates, window_s, bytes_moved and the
             worst op printed; (b) pagerank AUTO on phase 4's edges through
             a store whose hot budget is below the rank vector, G once a
             round, the same wire traffic as phase 4's untiered run and its
             ranks within the app tolerance (the credits' fp64 atomics and
             the arrival-order fold make no two runs bit-equal; whether
             these are is printed), each payload loaded back from the tier
             with the bits it left the card with, a Watchdog polling and
             firing nothing; (c) the FT drill at Covertype scale: kmeans on
             4 nodes x 1 thread over 4 shards, node 2 declared dead by the
             HeartbeatMonitor (metrics_payload on the beats), recovered
             single (3 x 2 threads) and multi (3 x 1), only shard 2's names
             moved with their epochs, the recovered session's kmeans (D
             once a thread a round) held to a fresh session of the same
             shape; (d) kmeans' centers, pagerank's ranks, a bf16 leaf and
             a sample of the points checkpointed from the card (once through
             AsyncCheckpointer), restored by restore_checkpoint and
             elastic_restore onto a 4-position mesh, bit-equal on the card.
7. lm      — qwen3-1.7b (flash attention), mamba2-2.7b (SSD scan) and
             zamba2-2.7b (both: 54 mamba layers, a weight-shared attention
             block after every 6) at their full published configs, random
             weights and inputs from SEED (the same on any device), device
             left at its default; every rate is tokens over run_app's wall,
             after its collection and synchronize: (a)
             make_prefill_step on 4 x 2048 tokens, which must launch each
             kernel as LM_MODELS says (once a layer; zamba2 flash_attention
             9, ssd_scan 54); (b) forward on a 256-token prompt against 256
             decode steps of it: max |dlogit| <= 1e-3 max |logit| and the
             same argmax at every position, the decode steps timed in four
             64-step blocks; mamba2's and zamba2's gaps are printed for their
             plain forwards too (chunked SSD, and blocked attention for
             zamba2), on the same weights; (c) serve(smoke=False) with 4 x 32
             prompt tokens and 32 generated.  Each model is freed before the
             next.  The moe family runs in fp32 cut in whole layers:
             moonshot-v1-16b-a3b at 24 of 48 (E x 24 a forward),
             deepseek-v3-671b (MLA, dk 192 / dv 128) at 4 of 61 (its 3
             dense layers and one MoE layer; E x 4); in (b) the forward
             runs at capacity factor 8.0 (deepseek 16.0: its random
             router's skew, MOE_FORWARD_CAPACITY), each MoE layer's input is kept by
             a forward hook and no expert's load may pass C, the decode
             steps at E / k (C = the batch), the routed experts of the two
             are compared and the kernel forward is printed against the
             blocked one; (c) serves them under smoke_config (neither whole
             config fits one card).
             Then repro's serving policy, bf16 parameters and compute
             (BF16_RUNS): qwen3-1.7b, mamba2-2.7b and zamba2-2.7b whole,
             moonshot-v1-16b-a3b whole (48 layers, the router fp32),
             deepseek-v3-671b at 4 of 61 layers and the vlm at 7 of 20
             superblocks (after its fp32 run below): the build timed; a
             4 x 2048 prefill for qwen3, moonshot and the vlm (E's bf16
             body once a layer); the kernels' forward on 256 tokens (E in
             bf16, F in bf16) against 256 bf16 decode steps, timed in four
             64-step blocks with their peak memory, within BF16_DECODE_GAP
             of max |logit|, each argmax flip printed with its top-2
             margin; where fp32 fits (not moonshot whole, nor the vlm, nor
             qwen2-72b's cut; mamba2 and zamba2 at BF16_DEEP's cut only),
             the fp32 decode of the same bf16 weights beside it (error rms
             over the logits' rms within BF16_VS_F32_RMS, max within
             BF16_DECODE_GAP but for the moe family's routing flips); then
             serve(smoke=False) at the same cut in bf16.  The
             vlm: llama-3.2-vision-90b in fp32 cut to 3
             of its 20 superblocks (each 4 self blocks and a cross block,
             every width as published): (a) a 4 x 2048 prefill over 1,601
             random vision embeddings of width 7,680, E x 15 (12 self, 3
             cross); (b) its forward on 256 tokens against 256 decode steps
             over cross caches the script fills with the vision K/V
             (repro's decode never fills them), the same gap limit; (c)
             serve(smoke=False) at the same cut on the zero cross caches, as
             repro serves it; then 7 of 20 superblocks in bf16, one prefill
             (E's bf16 body x 35).  The dense family's last three configs
             as qwen3-1.7b is run, in fp32 and in bf16 (LM_MODELS,
             BF16_RUNS): starcoder2-3b (LayerNorm, GELU FFN with biases,
             QKV bias; E x 30 at G 12) and qwen3-4b (qk-norm; E x 36 at G
             4) whole, qwen2-72b (QKV bias; E at G 8) cut to
             QWEN2_LAYERS_F32 of 80 layers in fp32 and QWEN2_LAYERS_BF16 in
             bf16, served in bf16 only; their forward-vs-decode argmax may
             differ only at a near tie, each flip printed with its margin.
             hubert-xlarge whole in fp32: a 4 x 2048-
             frame encode (E x 48, its share printed) and the kernel's
             logits against blocked attention's on 256 frames.  The int8
             KV cache: qwen3-1.7b at full width, 256 teacher-forced steps
             whose cache's codes and scales must be bit-equal to the CPU
             quantizer's on the K/V rows the steps quantized; the int8 and
             the unquantized decode timed in four 64-step blocks and their
             gap printed; at smoke size (qwen2-72b) the int8 decode within
             0.15 of the unquantized one at every step.  Last, long_500k:
             build_cell(cfg in bf16, SHAPES["long_500k"], make_host_mesh(1,
             1)) for mamba2-2.7b and zamba2-2.7b (its 9 KV caches 48.3 GB):
             a warm-up step, then one decode step against the 524,288-deep
             cache, its wall and peak memory printed, finite logits;
             mamba2's step from drawn states against the CPU's from the
             same state and weights, zamba2's caches each written at the
             step's slot and nowhere else (run_long_500k).
8. train   — training on the card (device left at its default); first
             the full-width weight draw of qwen3-1.7b and zamba2-2.7b
             timed beside the pre-seed draw of the same leaves: (a)
             train() on qwen3-1.7b at its full config (2.03 B parameters,
             fp32, AdamW + warmup_cosine + clip 1.0, LMDataPipeline), 8
             steps of 8 x 128 tokens: finite losses, the trained weights'
             loss on the first step's batch below that step's logged loss,
             no flash_attention launch (blocked attention, as repro
             trains); each step's seconds, the median tokens/s of steps 2-7
             and the peak device memory printed; then a backward through
             the flash kernel (smoke_config, attention_impl="pallas") must
             raise NotImplementedError; (b) train() on smoke_config from
             SEED, 10 steps on the card against the same 10 on the CPU, each
             drawing its own weights (losses within 1e-4 relative), and
             train() stopped by a
             checkpoint under build/ at step 6 and resumed, against its
             uninterrupted run (within 1e-5; whether bit-equal is printed);
             (c) mamba2-2.7b at full width cut to 16 of its 64 layers, 4
             steps with finite losses, step times and peak memory printed;
             (d) ZeRO-1 over 4 mesh positions as threads: qwen3-1.7b at full
             width cut to 2 layers (723 M parameters), each position's
             gradient of its quarter of an 8 x 128 batch through
             zero1_update for 3 steps, the gathered fp32 master held to a
             replicated AdamW on the position-order mean gradient (rtol
             1e-5, atol 1e-7) and the bf16 params to 2e-2; (e)
             compressed_accumulate on each position's packed gradient of (d)
             at k = n/32 (topk_compress's argmax body) and n/4 (its bitonic
             body): per position sent + residual == corrected, the pairs
             equal to topk_compress's plain version, the total equal to the
             plain densify of the positions' sent pairs, all bit for bit,
             and the launches of both bodies and of sparse_scatter_add as
             the code gives them; (f) train() on zamba2-2.7b at its full
             config (2.42 B parameters, fp32, as (a)), 4 steps: finite
             losses, no flash_attention or ssd_scan launch, step seconds,
             tokens/s and peak memory printed; then a backward through
             either kernel on its smoke_config must raise; (g)
             moonshot-v1-16b-a3b at full width cut to 3 layers (1 dense +
             2 MoE, 1.93 B parameters), 4 steps of 8 x 128: finite losses
             and balance losses, no flash_attention launch, step seconds,
             tokens/s and peak printed; (h) deepseek-v3-671b's
             smoke_config (MLA + MoE + MTP), 10 steps on the card against
             the CPU (within 1e-4), and a backward through the flash kernel
             (MLA on it) must raise; (i) train() on hubert-xlarge at its
             full config (945.6 M parameters), 4 steps of 8 x 128 frames
             (blocked attention); the vlm's smoke_config card against CPU
             (within 1e-4); a backward through the flash kernel must raise
             for both families.  The vlm at full width does not train on
             one card: its embeddings and head alone are 2.1 B parameters.
             (j) starcoder2-3b's and qwen2-72b's smoke_config card against
             CPU (within 1e-4): QKV bias's gradients on the card.
9. mesh    — expert parallelism (moe_impl="ep") over a mesh of positions
             as threads on the card, through build_cell: (a)
             moonshot-v1-16b-a3b in fp32 cut to 24 of its 48 layers, every
             width as published, on make_host_mesh(data=2, model=4): 8
             positions of 16 experts each at the config's capacity factor;
             a 4 x 2048 prefill, E x 24, its tokens/s and peak memory
             printed beside phase 7's gather-path prefill, and the
             collectives one forward records equal to the analytic count
             (per position and MoE layer: two all-to-alls of E x C x D x 4
             bytes, one all-gather of the position's tokens, one all-reduce
             of the aux loss); (b) the same weights on 4 x 256 tokens at
             capacity factor E / k (no slot can drop on either path), EP
             against the gather path within 1e-4 of max |logit| (argmax
             flips counted with their near ties), the expert loads against
             C, and EP twice bit-equal; (c) moonshot's smoke_config with
             moe_impl="ep": train(data=2, model_axis=2) from SEED, 10 steps
             on the card against the same on the CPU (within 1e-4
             relative), and one backward through an EP layer with finite,
             nonzero gradients;
             (d) the dry run of deepseek-v3-671b's prefill_32k cell on meta
             over the 256-position production mesh (dryrun.run_cell), its
             RooflineRecord on the H100's constants and its wall time
             printed (moonshot-v1-16b-a3b's as well where deepseek's passes
             60 s).
10. result — the script's wall, one ``{"kernels": [...]}`` JSON line, the
             nvidia-smi line, and the ``{"ok": true, ...}`` line last.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib
import importlib.util
import io
import json
import os
import re
import statistics
import sys
import tempfile
import threading
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import card_info, configs  # noqa: E402
from repro_torch.analytics import kmeans, logreg, nmf, pagerank  # noqa: E402
from repro_torch.check import CheckError  # noqa: E402
from repro_torch.check import checker as stepcheck  # noqa: E402
from repro_torch.configs import get_arch, smoke_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    HostBackend, Session, SpmdBackend, make_mesh, pack_spec, pack_tree, telemetry)
from repro_torch.core.compat import (  # noqa: E402
    P, axis_index, axis_size, record_collectives, run_positions, shard_map)
from repro_torch.configs.base import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.core.shards import ShardedStore  # noqa: E402
from repro_torch.core.tiers import DiskTier, HostMemTier  # noqa: E402
from repro_torch.core.sparse import block_layout, blocked_topk_sparsify, densify  # noqa: E402
from repro_torch.data import (  # noqa: E402
    CSRMatrix, LMDataPipeline, kmeans_dataset, lm_batch, logreg_dataset, nmf_dataset,
    partition_rows, powerlaw_graph, shard_batch)
from repro_torch.ft import (  # noqa: E402
    AsyncCheckpointer, HeartbeatMonitor, elastic_restore, metrics_payload, restore_checkpoint,
    save_checkpoint, session_recovery)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.accumulate.kernel import accumulate_blocked  # noqa: E402
from repro_torch.kernels.accumulate.ref import accumulate_plain  # noqa: E402
from repro_torch.kernels.accumulate.fused_scatter import (  # noqa: E402
    fused_topk_scatter, fused_topk_scatter_plain)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_bhsd, gqa_plain, smem_bytes)
from repro_torch.kernels.flash_attention.ref import attention_bhsd_ref  # noqa: E402
from repro_torch.kernels.kmeans_assign.ops import (  # noqa: E402
    kmeans_assign, kmeans_assign_plain)
from repro_torch.kernels.logreg_margin.ops import (  # noqa: E402
    margin_residuals, margin_residuals_plain)
from repro_torch.kernels.nmf_init import ops as nmf_init  # noqa: E402
from repro_torch.kernels.nmf_products import ops as nmf_products  # noqa: E402
from repro_torch.kernels.pagerank_credits.ops import bin_edges, binned_credits  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import smem_bytes as ssd_smem_bytes  # noqa: E402
from repro_torch.kernels.ssd_scan.kernel import ssd_scan  # noqa: E402
from repro_torch.kernels.sparse_update.kernel import sparse_scatter_add  # noqa: E402
from repro_torch.kernels.sparse_update.ref import sparse_scatter_add_plain  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain  # noqa: E402
from repro_torch.kernels.topk_compress.ops import (  # noqa: E402
    BITONIC_MIN_K, topk_compress, topk_compress_plain)
from repro_torch.launch import dryrun, make_host_mesh, shardings  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import build_cell, make_prefill_step, make_train_step  # noqa: E402
from repro_torch.launch.train import batch_for, train  # noqa: E402
from repro_torch.models import attention, build_model, common  # noqa: E402
from repro_torch.models.common import InitStream, rms_norm  # noqa: E402
from repro_torch.models.ffn import MoE, capacity, expert_loads, routed_experts  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.optim import (  # noqa: E402
    adamw, compressed_accumulate, compression_ratio, ef_init, warmup_cosine, zero1_gather_params,
    zero1_init, zero1_update)

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12     # H100 SXM dense TF32 on the tensor cores
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores
BF16 = torch.bfloat16
DTYPE_NAMES = {torch.float32: "f32", BF16: "bf16"}
APP_TOL = dict(rtol=1e-5, atol=1e-6)
N_NODES, THREADS_PER_NODE = 2, 2
N_THREADS = N_NODES * THREADS_PER_NODE
SPMD_POSITIONS = 4          # the SPMD backend's mesh: positions as threads on the card
ITERS = 10
SEED = 0

# pagerank: SNAP soc-LiveJournal1 has 4,847,571 vertices and 68,993,773 edges
LJ_VERTICES, LJ_DEGREE = 4_847_571, 14
# kmeans: the UCI Covertype (FOREST) shape, 581,012 rows x 54 features, 7 classes
COV_ROWS, COV_FEATURES, COV_K = 581_012, 54, 7
# logreg over a CSR x: rows of 29 or 30 of 1,000,003 features (123 bins of
# the binned kernel: one scatter pass), Zipf(1.0) popularity, as the
# benchmark's kdd2010 (bridge) cell draws them at its 19.3 M x 29.9 M
LR_CSR = {"rows": 200_000, "features": 1_000_003, "nnz": 5_880_017, "zipf_exponent": 1.0}
# and the cell's own: kdd2010 (bridge)'s 19,264,097 rows, 29,890,095 features
# and 566,345,888 nonzeros, of which a thread's slice holds a quarter
LR_CELL = {"rows": 19_264_097, "features": 29_890_095, "nnz": 566_345_888,
           "zipf_exponent": 1.0}
# logreg: 1M rows x 512 features, sparse gradients with a budget of 32; the
# gradient is a sum over rows, so the step shrinks with the row count (the
# JAX package's tests step 1e-3 over 400 rows)
LR_ROWS, LR_FEATURES, LR_K = 1_000_000, 512, 32
LR_STEP = 0.4 / LR_ROWS
# nmf: the Netflix prize matrix is 480,189 users x 17,770 movies; the movie
# columns are kept whole and the users cut to 50,000, so that the host can
# make R (3.55 GB of fp32) from the seed; rank 64
NETFLIX_USERS, NMF_ROWS, NMF_COLS, NMF_RANK = 480_189, 50_000, 17_770, 64
NMF_ROUND = NMF_RANK * NMF_COLS + NMF_RANK ** 2     # the Q round: k·m + k² floats
# nmf_dataset(seed) and fit(seed) draw P then Q from one stream: from the
# data's own seed the fit would start at the true factors
NMF_INIT_SEED = SEED + 1
ACC_TOL = {torch.float32: None, torch.bfloat16: 3e-2}      # test_kernels.py:13
SCATTER_TOL = dict(rtol=1e-5, atol=1e-6)                   # test_kernels.py:155

KERNELS = {
    "fused_topk_scatter": ("src/repro_torch/csrc/fused_scatter.cu",
                           "src/repro/kernels/accumulate/fused_scatter.py:61"),
    "topk_compress_argmax": ("src/repro_torch/csrc/topk_compress.cu",
                             "src/repro/kernels/topk_compress/kernel.py:33"),
    "topk_compress_bitonic": ("src/repro_torch/csrc/topk_compress.cu",
                              "src/repro/kernels/topk_compress/kernel.py:52"),
    "kmeans_assign": ("src/repro_torch/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign/kernel.py:31"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:70"),
    "flash_attention_bf16": ("src/repro_torch/csrc/flash_attention.cu",
                             "src/repro/kernels/flash_attention/kernel.py:70"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:62"),
    "accumulate_blocked": ("src/repro_torch/csrc/accumulate.cu",
                           "src/repro/kernels/accumulate/kernel.py:23"),
    "sparse_scatter_add": ("src/repro_torch/csrc/scatter_add.cu",
                           "src/repro/kernels/sparse_update/kernel.py:39"),
    "pagerank_credits": ("src/repro_torch/csrc/pagerank_credits.cu",
                         "no TPU kernel: XLA's scatter, src/repro/analytics/pagerank.py:30"),
    "logreg_margin": ("src/repro_torch/csrc/logreg_margin.cu",
                      "no TPU kernel: the JAX package's logreg takes a dense x, "
                      "src/repro/analytics/logreg.py:34"),
    "nmf_init": ("src/repro_torch/csrc/nmf_init.cu",
                 "no TPU kernel: numpy's default_rng(seed).normal on the host, "
                 "src/repro/analytics/nmf.py:64"),
    "nmf_products_rqt": ("src/repro_torch/csrc/nmf_products.cu",
                         "no TPU kernel: XLA's product r @ q.T, src/repro/analytics/nmf.py:27"),
    "nmf_products_ptr": ("src/repro_torch/csrc/nmf_products.cu",
                         "no TPU kernel: XLA's product p.T @ r, src/repro/analytics/nmf.py:32"),
}
# a kernels line row counted by another row's launch counter: nmf's two
# products are one library and one counter
LAUNCH_COUNTER = {"nmf_products_rqt": "nmf_products", "nmf_products_ptr": "nmf_products"}

# qwen2-72b (72.7 B parameters, 291 GB in fp32) cut in whole layers: the most
# that leave the card >= 8 GB beside a 4 x 2048 prefill's peak
# (scripts/torch_depth_cut.py), in fp32 and in bf16
QWEN2_LAYERS_F32, QWEN2_LAYERS_BF16 = 15, 36
# the dense archs whose forward and decode may pick different tokens where
# the forward's top two logits lie within 2 max |dlogit| (random weights
# over ~150k classes), each flip printed with its margin; and the one whose
# fp32 cut is not served (its bf16 cut is)
NEAR_TIE_ARCHS = ("starcoder2-3b", "qwen3-4b", "qwen2-72b")
BF16_SERVE_ONLY = ("qwen2-72b",)
# phase 3's row whose E shape an arch's prefill gives E (qwen2-72b's 64 query
# heads over 8 at head dim 128 are the vlm's self attention's)
E_SHAPE_OF = {"qwen2-72b": "llama-3.2-vision-90b self"}

# the LM serving path: each model at its full published widths, with the
# prefill implementations that run its kernels and the launches of each in
# one prefill forward (zamba2: 9 applications of the shared attention block,
# 54 mamba layers); the moe family in fp32, its configs' dtype, cut in whole
# layers, the leading dense layers and MoE layers after them kept (whole,
# moonshot-v1-16b-a3b holds 28.4 B parameters, 113.5 GB, and
# deepseek-v3-671b ~2.7 TB); the dense family's starcoder2-3b (12.7 GB) and
# qwen3-4b (17.6 GB) whole, qwen2-72b at QWEN2_LAYERS_F32 of 80 layers
LM_MODELS = {"qwen3-1.7b": ({"attention_impl": "pallas"}, {"flash_attention": 28}),
             "mamba2-2.7b": ({"ssd_impl": "pallas"}, {"ssd_scan": 64}),
             "zamba2-2.7b": ({"attention_impl": "pallas", "ssd_impl": "pallas"},
                             {"flash_attention": 9, "ssd_scan": 54}),
             "moonshot-v1-16b-a3b": ({"attention_impl": "pallas", "n_layers": 24},
                                     {"flash_attention": 24}),
             "deepseek-v3-671b": ({"attention_impl": "pallas", "n_layers": 4},
                                  {"flash_attention": 4}),
             "starcoder2-3b": ({"attention_impl": "pallas"}, {"flash_attention": 30}),
             "qwen3-4b": ({"attention_impl": "pallas"}, {"flash_attention": 36}),
             "qwen2-72b": ({"attention_impl": "pallas", "n_layers": QWEN2_LAYERS_F32},
                           {"flash_attention": QWEN2_LAYERS_F32})}
# repro's serving policy, bf16 parameters and compute (run_lm_bf16): each
# arch's cut, the kernels' launches in one forward, whether it also runs a
# 4 x 2048 prefill and whether its fp32 build fits beside nothing else for
# the fp32 decode of the same weights: qwen3-1.7b (4.06 GB), mamba2-2.7b
# (5.66 GB) and zamba2-2.7b (4.85 GB) whole; moonshot-v1-16b-a3b whole
# (56.8 GB, the router fp32: 113.5 GB in fp32); deepseek-v3-671b at 4 of 61
# layers (31.6 GB; the absorbed MLA decode); llama-3.2-vision-90b at 7 of 20
# superblocks (64.2 GB), its cross caches filled as run_vlm fills them;
# starcoder2-3b (6.36 GB) and qwen3-4b (8.82 GB) whole; qwen2-72b at
# QWEN2_LAYERS_BF16 of 80 layers (no fp32 beside it)
BF16_RUNS = {
    "qwen3-1.7b": ({"attention_impl": "pallas"},
                   {"flash_attention_bf16": 28, "flash_attention": 28}, True, True),
    "mamba2-2.7b": ({"ssd_impl": "pallas"}, {"ssd_scan": 64}, False, True),
    "zamba2-2.7b": ({"attention_impl": "pallas", "ssd_impl": "pallas"},
                    {"flash_attention_bf16": 9, "flash_attention": 9, "ssd_scan": 54},
                    False, True),
    "moonshot-v1-16b-a3b": ({"attention_impl": "pallas"},
                            {"flash_attention_bf16": 48, "flash_attention": 48}, True, False),
    "deepseek-v3-671b": ({"attention_impl": "pallas", "n_layers": 4},
                         {"flash_attention_bf16": 4, "flash_attention": 4}, False, True),
    "llama-3.2-vision-90b": ({"attention_impl": "pallas", "n_layers": 35},
                             {"flash_attention_bf16": 35, "flash_attention": 35}, True, False),
    "starcoder2-3b": ({"attention_impl": "pallas"},
                      {"flash_attention_bf16": 30, "flash_attention": 30}, True, True),
    "qwen3-4b": ({"attention_impl": "pallas"},
                 {"flash_attention_bf16": 36, "flash_attention": 36}, True, True),
    "qwen2-72b": ({"attention_impl": "pallas", "n_layers": QWEN2_LAYERS_BF16},
                  {"flash_attention_bf16": QWEN2_LAYERS_BF16,
                   "flash_attention": QWEN2_LAYERS_BF16}, True, False),
}
# bf16 limits, each of the step's logits: the forward against the decode,
# and the decode against the fp32 decode of the same weights (max |dlogit|
# over max |logit|), from tests/test_torch_bf16_decode.py (zamba2 3.75e-2
# against repro's bf16, the most of five families); the error's rms over
# the logits' rms against the fp32 decode (1.84e-2 at most at smoke size)
BF16_DECODE_GAP, BF16_VS_F32_RMS = 6e-2, 6e-2
# the ssm and hybrid stacks at full depth: bf16's rounding grows layer by
# layer through their random weights (the fp32 gap too: mamba2 1.3e-5 at 2
# layers, 5.6e-4 at 64), so a whole model's bf16 forward and decode, and
# its bf16 and fp32 decodes, part as far as rounding apart lets them
# (mamba2 0.94 of max |logit| on the card; scripts/torch_bf16_depth.py on
# the CPU at full width: 3.2e-2 at 2 layers, 9.0e-2 at 4, 2.2e-1 at 16):
# printed whole (the forward against the decode; the decode against the
# fp32 decode of the same weights only at the cut: the whole-depth one,
# 0.48 rms for mamba2, is in PERF.md), gated at a cut of (layers, the
# kernels' launches a forward) by the error's rms over the logits' rms,
# within BF16_VS_F32_RMS for the forward against the decode and for the
# decode against fp32's
# (max |dlogit|, an extreme over 1,024 positions, printed: zamba2's one
# superblock 7.6e-2 at batch 1 on the CPU, 1.6e-1 at batch 4 on the card;
# its rms 4.0e-2 and 3.9e-2)
BF16_DEEP = {"mamba2-2.7b": (2, {"ssd_scan": 2}),
             "zamba2-2.7b": (6, {"flash_attention_bf16": 1, "flash_attention": 1,
                                 "ssd_scan": 6})}
# (b) for the moe family: the forward drops slots past C batch-wide, while
# decode routes one step at a time (so tests/test_archs_smoke.py raises the
# capacity too, to 8.0); the forward's capacity factor is one at which no
# expert of the 4 x 256 forward passes C (checked on each MoE layer's
# input, recorded by a forward hook): 8.0, but deepseek's random weights
# send 441 of its 8,192 slots to one expert (13.8 x the mean of 32; C 256
# at 8.0), so 16.0 there (C 512); at E / k the decode step's C is its batch
MOE_FORWARD_CAPACITY = {"moonshot-v1-16b-a3b": 8.0, "deepseek-v3-671b": 16.0}
# a routing difference between the forward and the decode steps must be a
# near tie: the router's k + 1 largest probabilities this close somewhere
# (the two paths' inputs to a layer differ by fp32 rounding, ~1e-6)
ROUTING_TIE = 1e-4
LM_BATCH, LM_PREFILL, LM_CONSISTENCY, DECODE_BLOCK = 4, 2048, 256, 64
VLM_VISION_TOKENS = get_arch("llama-3.2-vision-90b").vision_tokens        # 1,601
FLASH_TOL = {torch.float32: 3e-5, torch.bfloat16: 3e-2}   # test_kernels.py:13
SSD_TOL = dict(rtol=3e-4, atol=3e-4)                       # test_kernels.py:193
BF16_TOL = dict(rtol=3e-2, atol=3e-2)                      # the repo's bf16 tolerance
# inputs the JAX package's kernels take off the float32 main path
# (tests/test_torch_inputs.py's cuda shapes): A (N, V, k, block) and
# B/C (V, k, block) at blocks past 1,024 lanes: A keeps its values in
# registers to 2,048 lanes and reads x again on each pass past that; B and
# C keep their keys in registers to 16,384; at 65,536 C reads x again on
# each pass and B streams chunks of 16,384 lanes through its warps' lists
# (k 300: B in two segments of at most 256 keys); D (N, D, K): K
# 1,024 at D 64 and K 9,000 at D 8 (the tiles body), D 60,000 (the wide
# body, D split across a CTA; its points integer-valued, so that sums of
# 60,000 products are exact in fp32 in any order and kernel and plain agree
# exactly)
A_INPUTS = [(4, 16384, 512, 1024), (3, 900, 900, 256), (4, 30_000, 3000, 2048),
            (4, 40_000, 4000, 16_384), (2, 150_000, 9000, 65_536),
            (3, 70_000, 70_000, 65_536)]
C_INPUTS = [(4096, 256, 1024), (2048, 16, 512), (30_000, 40, 2048), (40_000, 300, 16_384),
            (150_000, 24, 65_536), (200_000, 100, 65_536)]
D_INPUTS = [(20_000, 64, 1024), (3000, 8, 9000), (300, 60_000, 3)]


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, reps: int) -> float:
    """Median over ``reps`` CUDA-event timings of one call, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, reps: int) -> float:
    """Device time of one call: ``fn`` captured once in a CUDA graph, the
    graph replayed ``reps`` times between two CUDA events.  Where a call's
    host work (Python, the wrapper's checks, the launch) outlasts its device
    work, :func:`time_ms` reads the host; this reads the device alone."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float = 0.0, flops_per_s: float = FP32_FLOPS_PER_S) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rng_sparse(rng, shape, density):
    x = rng.normal(size=shape).astype(np.float32)
    x[rng.random(shape) >= density] = 0.0
    return torch.from_numpy(x).cuda()


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_kernels(rng) -> dict:
    results = {}

    # A: fused_topk_scatter — test_kernels.py's five shapes x four densities
    for n, v, k, block in [(4, 16384, 512, 1024), (8, 1000, 50, 256),
                           (1, 100, 10, 1024), (3, 900, 900, 256), (2, 7, 3, 1024)]:
        _, be, pb = block_layout(v, k, block)
        for density in (0.0, 0.01, 0.3, 1.0):
            x = rng_sparse(rng, (n, v), density)
            got = fused_topk_scatter(x, per_block=pb, block_eff=be)
            if not torch.equal(got, fused_topk_scatter_plain(x, pb, be)):
                raise AssertionError(f"fused_topk_scatter differs at {(n, v, k, block, density)}")
    # main paths: pagerank SPARSE (N=4 credit vectors of V=4,847,571,
    # k=V//4) and logreg SPARSE (N=4 gradients of V=512, k=32, one 512-lane
    # block); the pagerank shape is the one reported in the kernels line
    a_shapes = {"pagerank": (LJ_VERTICES, LJ_VERTICES // 4, (0.3,)),
                "logreg": (LR_FEATURES, LR_K, (0.3, 1.0))}
    per_shape, err = {}, 0.0
    for app, (v, kk, densities) in a_shapes.items():
        _, be, pb = block_layout(v, kk)
        for density in densities:
            x = rng_sparse(rng, (N_THREADS, v), density)
            got = fused_topk_scatter(x, per_block=pb, block_eff=be)
            ref = fused_topk_scatter_plain(x, pb, be)
            if not torch.equal(got, ref):
                raise AssertionError(f"fused_topk_scatter differs at the {app} shape "
                                     f"(density {density})")
            err = max(err, float((got - ref).abs().max()))
        t, by = bound_ms((N_THREADS + 1) * v * 4)
        per_shape[app] = dict(
            shape=f"x ({N_THREADS}, {v}) f32, block_eff={be}, per_block={pb}",
            ms=time_ms(lambda: fused_topk_scatter(x, per_block=pb, block_eff=be), 20),
            device_ms=graph_ms(lambda: fused_topk_scatter(x, per_block=pb, block_eff=be), 20),
            plain_ms=time_ms(lambda: fused_topk_scatter_plain(x, pb, be), 5),
            bound_ms=t, bound_by=by, library_ms=None)
    log("fused_topk_scatter per main-path shape:", json.dumps(per_shape))
    results["fused_topk_scatter"] = dict(per_shape["pagerank"], max_abs_err=err)

    # B and C: topk_compress — test_kernels.py's sweeps, ties at zero, k >= 65
    for v, k, bv in [(900, 4, 256), (2048, 16, 512), (100, 2, 64), (1000, 200, 256),
                     (4096, 256, 1024), (7, 3, 1024), (4096, BITONIC_MIN_K, 1024)]:
        x = rng_sparse(rng, (v,), 0.5)
        pi, pv = topk_compress_plain(x, k, min(bv, v))
        outs = [topk_compress(x, k_per_block=k, block_v=bv, method=m)
                for m in ("argmax", "bitonic")]
        for (i, val), m in zip(outs, ("argmax", "bitonic")):
            if not (torch.equal(i, pi) and torch.equal(val, pv)):
                raise AssertionError(f"topk_compress {m} differs at {(v, k, bv)}")
    # main paths: logreg unfused (V=512, k=32 -> argmax) and pagerank
    # unfused (V=4,847,571, k_per_block=256 -> bitonic); both bodies timed
    # at both shapes, so the BITONIC_MIN_K crossover can be read off
    shapes = {"topk_compress_argmax": (LR_FEATURES, LR_K),
              "topk_compress_bitonic": (LJ_VERTICES, LJ_VERTICES // 4)}
    crossover = {}
    for name, (v, kk) in shapes.items():
        nb, be, pb = block_layout(v, kk)
        x = rng_sparse(rng, (v,), 0.3)
        pi, pv = topk_compress_plain(x, pb, be)
        per_method, err = {}, {}
        for m in ("argmax", "bitonic"):
            i, val = topk_compress(x, k_per_block=pb, block_v=be, method=m)
            if not (torch.equal(i, pi) and torch.equal(val, pv)):
                raise AssertionError(f"topk_compress {m} differs at V={v}")
            err[m] = float((val - pv).abs().max())
            per_method[m] = time_ms(
                lambda m=m: topk_compress(x, k_per_block=pb, block_v=be, method=m), 20)
        crossover[f"V={v},k_per_block={pb}"] = per_method
        # yardstick: torch.topk of the blocked magnitudes (its tie order is
        # unspecified, so it is timed only, never used)
        mags = torch.nn.functional.pad(x.abs(), (0, nb * be - v)).reshape(nb, be)
        method = name.rsplit("_", 1)[1]
        t, by = bound_ms(v * 4 + nb * pb * 8)
        results[name] = dict(
            shape=f"x ({v},) f32, block_v={be}, k_per_block={pb}",
            max_abs_err=err[method], ms=per_method[method],
            plain_ms=time_ms(lambda: topk_compress_plain(x, pb, be), 5),
            bound_ms=t, bound_by=by,
            library_ms=time_ms(lambda: torch.topk(mags, pb, dim=1), 20),
            device_ms=graph_ms(lambda: topk_compress(x, k_per_block=pb, block_v=be,
                                                     method=method), 50),
            library_device_ms=graph_ms(lambda: torch.topk(mags, pb, dim=1), 50))
    # the BITONIC_MIN_K evidence: both bodies over k_per_block on 1024-lane
    # blocks of the pagerank-sized vector, a call and on the device
    x = rng_sparse(rng, (LJ_VERTICES,), 0.3)
    for kpb in (4, 8, 16, 32, 64, 128, 256):
        for m in ("argmax", "bitonic"):
            call = lambda m=m: topk_compress(x, k_per_block=kpb, block_v=1024, method=m)
            crossover.setdefault(f"V={LJ_VERTICES},k_per_block={kpb}", {})[m] = \
                (time_ms(call, 10), graph_ms(call, 10))
    log("topk_compress crossover (ms, argmax vs bitonic; the main-path shapes a call, "
        "the sweep a call and device):", json.dumps(crossover))

    # D: kmeans_assign — test_kernels.py's sweep, then one thread's share of
    # the Covertype-shaped data against the initial centers, as kmeans.fit
    # gives them on its first round
    for n, k, d in [(500, 11, 24), (1000, 3, 8)]:
        pts = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).cuda()
        ctr = torch.from_numpy(rng.normal(size=(k, d)).astype(np.float32)).cuda()
        a, dist = kmeans_assign(pts, ctr)
        check_assign(pts, ctr, a, dist, *kmeans_assign_plain(pts, ctr))
    # thread 0's share data[:n] and thread 1's data[n:2n], whose pointer is
    # 8-byte aligned (n·54·4 bytes ≡ 8 mod 16), as Session.spawn hands them
    data = torch.from_numpy(kmeans_dataset(COV_ROWS, COV_FEATURES, COV_K, seed=SEED)[0]).cuda()
    n, k, d = COV_ROWS // N_THREADS, COV_K, COV_FEATURES
    ctr = data[torch.from_numpy(np.random.default_rng(SEED).choice(
        COV_ROWS, COV_K, replace=False)).cuda()]
    t, by = bound_ms((n * d + k * d + 2 * n) * 4, 2.0 * n * k * d)
    per_share, err = {}, 0.0
    for tid in (0, 1):
        pts = data[tid * n:(tid + 1) * n]
        a, dist = kmeans_assign(pts, ctr)
        pa, pd = kmeans_assign_plain(pts, ctr)
        check_assign(pts, ctr, a, dist, pa, pd)
        err = max(err, float((dist - pd).abs().max()))
        per_share[f"thread {tid}"] = dict(
            shape=f"points ({n}, {d}) f32 at pointer mod 16 = {pts.data_ptr() % 16}, "
                  f"centers ({k}, {d})",
            ms=time_ms(lambda: kmeans_assign(pts, ctr), 20),
            device_ms=graph_ms(lambda: kmeans_assign(pts, ctr), 50),
            plain_ms=time_ms(lambda: kmeans_assign_plain(pts, ctr), 20),
            bound_ms=t, bound_by=by, library_ms=None)
    log("kmeans_assign per thread share:", json.dumps(per_share))
    results["kmeans_assign"] = dict(per_share["thread 0"], max_abs_err=err)
    return results


def check_receive(rng) -> dict:
    """accumulate_blocked and sparse_scatter_add against their plain versions
    at test_kernels.py's sweeps and at the shapes the main path gives them,
    each timed there (each also through the accumulator's entry, which skips
    the checks, as ``entry_ms``)."""
    from repro_torch.kernels.accumulate.kernel import accumulate_rows_unchecked
    from repro_torch.kernels.sparse_update.kernel import sparse_scatter_add_unchecked

    results = {}
    # G: accumulate_blocked — the sweep in fp32 (bit-exact) and bf16, as the
    # (N, V) tensor and as N separate rows; 70 rows exceed the pointer list
    for n, v, bv in [(4, 1024, 256), (7, 3000, 512), (1, 128, 128), (70, 1001, 1024)]:
        x = cuda_normal(rng, (n, v))
        for dtype, tol in ACC_TOL.items():
            xd = x.to(dtype)
            ref = accumulate_plain(xd)
            for form in (xd, [r.clone() for r in xd]):
                got = accumulate_blocked(form, block_v=bv)
                if tol is not None:
                    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
                elif not torch.equal(got, ref):
                    raise AssertionError(f"accumulate_blocked differs at {(n, v, bv)}")
    # main paths: the dense round of pagerank AUTO (4 credit vectors of V =
    # 4,847,571) and of nmf AUTO (4 x k·m + k²), each as the accumulator
    # holds it — N separate tensors — and stacked
    per_shape = {}
    for app, v in (("pagerank", LJ_VERTICES), ("nmf", NMF_ROUND)):
        rows = [cuda_normal(rng, (v,)) for _ in range(N_THREADS)]
        x = torch.stack(rows)
        got, ref = accumulate_blocked(rows), accumulate_plain(rows)
        if not (torch.equal(got, ref) and torch.equal(accumulate_blocked(x), ref)
                and torch.equal(accumulate_rows_unchecked(rows), ref)):
            raise AssertionError(f"accumulate_blocked differs at the {app} shape")
        t, by = bound_ms((N_THREADS + 1) * v * 4)
        per_shape[app] = dict(
            shape=f"{N_THREADS} rows of ({v},) f32",
            max_abs_err=float((got - ref).abs().max()),
            ms=time_ms(lambda: accumulate_blocked(rows), 20),
            entry_ms=time_ms(lambda: accumulate_rows_unchecked(rows), 20),
            plain_ms=time_ms(lambda: accumulate_plain(rows), 20),
            bound_ms=t, bound_by=by,
            library_ms=time_ms(lambda: torch.sum(x, dim=0), 20),
            device_ms=graph_ms(lambda: accumulate_blocked(rows), 50),
            library_device_ms=graph_ms(lambda: torch.sum(x, dim=0), 50))
    log("accumulate_blocked per main-path shape:", json.dumps(per_shape))
    results["accumulate_blocked"] = per_shape["pagerank"]

    # H: sparse_scatter_add — the sweep's random indices repeat inside the
    # row (held to the tolerance), the duplicates case, indices out of range
    dev = torch.device("cuda")
    for m, v, bv in [(50, 700, 256), (200, 4096, 1024), (1, 64, 64)]:
        idx = torch.from_numpy(rng.integers(0, v, size=(m,)).astype(np.int32)).to(dev)
        vals = cuda_normal(rng, (m,))
        torch.testing.assert_close(sparse_scatter_add(idx, vals, v, block_v=bv),
                                   sparse_scatter_add_plain(idx, vals, v), **SCATTER_TOL)
    idx = torch.tensor([3, 3, 3, 0, -1, 8, 100], dtype=torch.int32, device=dev)
    vals = torch.tensor([1.0, 2.0, 3.0, 5.0, 7.0, 11.0, 13.0], device=dev)
    got = sparse_scatter_add(idx, vals, 8, block_v=8)
    if got.tolist() != [5.0, 0.0, 0.0, 6.0, 0.0, 0.0, 0.0, 0.0]:
        raise AssertionError(f"sparse_scatter_add duplicates / out of range: {got.tolist()}")
    # the accumulator's pairs, bit-exact: (V, k) = (1030, 600) pads its last
    # block with 294 (0, 0.0) pairs per row; then the main paths, the
    # unfused rounds of pagerank (k = V/4) and logreg (k = 32), from real
    # compressions
    per_shape = {}
    for app, (v, kk, density) in (("padded", (1030, 600, 0.5)),
                                  ("pagerank", (LJ_VERTICES, LJ_VERTICES // 4, 0.3)),
                                  ("logreg", (LR_FEATURES, LR_K, 1.0))):
        pairs = [blocked_topk_sparsify(rng_sparse(rng, (v,), density), kk)
                 for _ in range(N_THREADS)]
        idx = torch.stack([p.idx for p in pairs])
        vals = torch.stack([p.vals for p in pairs])
        got, ref = sparse_scatter_add(idx, vals, v), sparse_scatter_add_plain(idx, vals, v)
        if not torch.equal(got, ref):
            raise AssertionError(f"sparse_scatter_add differs on the {app} pairs")
        if app == "padded":
            continue
        t, by = bound_ms(idx.numel() * (4 + 4) + v * 4)
        flat_i, flat_v = idx.reshape(-1), vals.reshape(-1)
        per_shape[app] = dict(
            shape=f"idx/vals ({N_THREADS}, {idx.shape[1]}) int32/f32 into {v} "
                  "(1 launch)",
            max_abs_err=float((got - ref).abs().max()),
            ms=time_ms(lambda: sparse_scatter_add(idx, vals, v), 20),
            entry_ms=time_ms(lambda: sparse_scatter_add_unchecked(idx, vals, v), 20),
            plain_ms=time_ms(lambda: sparse_scatter_add_plain(idx, vals, v), 5),
            bound_ms=t, bound_by=by,
            library_ms=time_ms(lambda: torch.zeros(v, device=dev).index_add_(
                0, flat_i, flat_v), 20),
            device_ms=graph_ms(lambda: sparse_scatter_add(idx, vals, v), 50),
            library_device_ms=graph_ms(lambda: torch.zeros(v, device=dev).index_add_(
                0, flat_i, flat_v), 50))
    log("sparse_scatter_add per main-path shape:", json.dumps(per_shape))
    results["sparse_scatter_add"] = per_shape["pagerank"]
    return results


def check_inputs(rng) -> dict:
    """Inputs the JAX package's kernels take off the float32 main path,
    each kernel held against its plain version on them:
    A and B/C bit-exact at bf16 and at blocks of 2,048, 16,384 and 65,536
    (A_INPUTS, C_INPUTS); D with the same assignments at bf16 (Covertype's
    shape) and at K 1,024 / D 64, K 9,000 and D 60,000; F within 3e-2 at
    bf16 (the mamba2-2.7b prefill shape) and within 3e-4 at chunk 256 (two
    sub-chunks of 128); A and C also at bf16 at pagerank's V.  Each is timed
    per call (CUDA events) beside its plain version and a bound (A past
    1,024 lanes; B and C at every C_INPUTS entry, and their device time
    by graph replay too; F 3xTF32, and its device time); the float32 main-path rows of phase 3 are the
    yardstick.  Returns the timings."""
    from repro_torch.kernels.ssd_scan.kernel import sub_chunk

    taken = {}

    def record(name, shape, fn, plain, nbytes, flops=0.0, reps=10, device=False,
               flops_per_s=FP32_FLOPS_PER_S):
        t, by = bound_ms(nbytes, flops, flops_per_s)
        taken[name] = dict(shape=shape, ms=time_ms(fn, reps), plain_ms=time_ms(plain, 3),
                           bound_ms=t, bound_by=by)
        if device:
            taken[name]["device_ms"] = graph_ms(fn, 20)

    # A: fused_topk_scatter
    for n, v, k, block in A_INPUTS:
        _, be, pb = block_layout(v, k, block)
        for dtype in (torch.float32, BF16):
            x = rng_sparse(rng, (n, v), 0.3).to(dtype)
            if not torch.equal(fused_topk_scatter(x, per_block=pb, block_eff=be),
                               fused_topk_scatter_plain(x, pb, be)):
                raise AssertionError(f"fused_topk_scatter differs at {(n, v, k, block, dtype)}")
            if block > 1024:
                record(f"A {DTYPE_NAMES[dtype]} block {be}", f"x ({n}, {v}), per_block {pb}",
                       lambda: fused_topk_scatter(x, per_block=pb, block_eff=be),
                       lambda: fused_topk_scatter_plain(x, pb, be),
                       (n + 1) * v * x.element_size())
    _, be, pb = block_layout(LJ_VERTICES, LJ_VERTICES // 4)
    x = rng_sparse(rng, (N_THREADS, LJ_VERTICES), 0.3).to(BF16)
    if not torch.equal(fused_topk_scatter(x, per_block=pb, block_eff=be),
                       fused_topk_scatter_plain(x, pb, be)):
        raise AssertionError("fused_topk_scatter differs at bf16 at pagerank's V")
    record("A bf16 pagerank", f"x ({N_THREADS}, {LJ_VERTICES}) bf16, block {be}, "
           f"per_block {pb}", lambda: fused_topk_scatter(x, per_block=pb, block_eff=be),
           lambda: fused_topk_scatter_plain(x, pb, be), (N_THREADS + 1) * LJ_VERTICES * 2,
           reps=20, device=True)

    # B/C: topk_compress, both bodies
    for v, k, bv in C_INPUTS:
        for dtype in (torch.float32, BF16):
            x = rng_sparse(rng, (v,), 0.5).to(dtype)
            pi, pv = topk_compress_plain(x, k, min(bv, v))
            for m in ("argmax", "bitonic"):
                i, val = topk_compress(x, k_per_block=k, block_v=bv, method=m)
                if not (torch.equal(i, pi) and torch.equal(val, pv)):
                    raise AssertionError(f"topk_compress {m} differs at {(v, k, bv, dtype)}")
                nb = -(-v // bv)
                record(f"{'B' if m == 'argmax' else 'C'} {DTYPE_NAMES[dtype]} block {bv} k {k}",
                       f"x ({v},), k_per_block {k}",
                       lambda m=m: topk_compress(x, k_per_block=k, block_v=bv, method=m),
                       lambda: topk_compress_plain(x, k, bv),
                       v * x.element_size() + nb * k * (4 + x.element_size()), device=True)
    nb, be, pb = block_layout(LJ_VERTICES, LJ_VERTICES // 4)
    x = rng_sparse(rng, (LJ_VERTICES,), 0.3).to(BF16)
    pi, pv = topk_compress_plain(x, pb, be)
    i, val = topk_compress(x, k_per_block=pb, block_v=be, method="bitonic")
    if not (torch.equal(i, pi) and torch.equal(val, pv)):
        raise AssertionError("topk_compress bitonic differs at bf16 at pagerank's V")
    record("C bf16 pagerank", f"x ({LJ_VERTICES},) bf16, block {be}, k_per_block {pb}",
           lambda: topk_compress(x, k_per_block=pb, block_v=be, method="bitonic"),
           lambda: topk_compress_plain(x, pb, be), LJ_VERTICES * 2 + nb * pb * 6,
           reps=20, device=True)

    # D: kmeans_assign at bf16 (thread 0's share of Covertype and thread 1's,
    # 4-byte aligned) and at the other bodies' shapes
    data, _, _ = kmeans_dataset(COV_ROWS, COV_FEATURES, COV_K, seed=SEED)
    n, k, d = COV_ROWS // N_THREADS, COV_K, COV_FEATURES
    bf = torch.from_numpy(data[:2 * n]).cuda().to(BF16)
    ctr = bf[torch.from_numpy(np.random.default_rng(SEED).choice(n, k, replace=False)).cuda()]
    for tid in (0, 1):
        pts = bf[tid * n:(tid + 1) * n]
        check_assign(pts.float(), ctr.float(), *kmeans_assign(pts, ctr),
                     *kmeans_assign_plain(pts, ctr))
        record(f"D bf16 covertype{' thread 1' if tid else ''}",
               f"points ({n}, {d}) bf16 at pointer mod 16 = {pts.data_ptr() % 16}, "
               f"centers ({k}, {d})",
               lambda: kmeans_assign(pts, ctr), lambda: kmeans_assign_plain(pts, ctr),
               (n * d + k * d) * 2 + 8 * n, 2.0 * n * k * d, reps=20, device=True)
    for n, d, k in D_INPUTS:
        for dtype in (torch.float32, BF16):
            if d > 10_000:
                pts = torch.from_numpy(rng.integers(-1, 2, size=(n, d)).astype(
                    np.float32)).cuda().to(dtype)
            else:
                pts = cuda_normal(rng, (n, d), dtype=dtype)
            ctr = pts[torch.from_numpy(rng.choice(n, k, replace=n < k)).cuda()].clone()
            got, want = kmeans_assign(pts, ctr), kmeans_assign_plain(pts, ctr)
            if d > 10_000 and not all(map(torch.equal, got, want)):
                raise AssertionError(f"kmeans_assign differs at D {d} ({dtype})")
            check_assign(pts.float(), ctr.float(), *got, *want)
            record(f"D {DTYPE_NAMES[dtype]} K {k} D {d}", f"points ({n}, {d}), centers ({k}, {d})",
                   lambda: kmeans_assign(pts, ctr), lambda: kmeans_assign_plain(pts, ctr),
                   (n * d + k * d) * pts.element_size() + 8 * n, 2.0 * n * k * d,
                   device=True)

    # F: ssd_scan at bf16 and at chunk 256, at the mamba2-2.7b prefill shape
    b, t, h, p, g, n = LM_BATCH, LM_PREFILL, 80, 64, 1, 128
    xbar, a, bm, cm = ssd_inputs(rng, b, t, h, p, g, n)
    for dtype, q in ((BF16, 128), (torch.float32, 256), (BF16, 256)):
        xq, bq, cq = (z.to(dtype) for z in (xbar, bm, cm))
        y = ssd_scan(xq, a, bq, cq, chunk=q)
        ref = ssd_scan_plain(xq, a, bq, cq, q)[0]
        torch.testing.assert_close(y.float(), ref.float(),
                                   **(SSD_TOL if dtype == torch.float32 else BF16_TOL))
        record(f"F {DTYPE_NAMES[dtype]} chunk {q} (walked as {sub_chunk(q, p, n)})",
               f"xbar ({b}, {t}, {h}, {p}), B/C ({b}, {t}, {g}, {n})",
               lambda: ssd_scan(xq, a, bq, cq, chunk=q),
               lambda: ssd_scan_plain(xq, a, bq, cq, q),
               xq.element_size() * (2 * xq.numel() + bq.numel() + cq.numel()) + 4 * a.numel(),
               3 * ssd_flops(b, t, h, p, n, sub_chunk(q, p, n)), reps=5, device=True,
               flops_per_s=TF32_FLOPS_PER_S)
    log("newly taken inputs, ms per call:", json.dumps(taken))
    return taken


def check_flash_bf16(rng) -> dict:
    """flash_attention's bf16 (wgmma) body at the qwen3-1.7b prefill shape
    (q (4, 2048, 8, 2, 128), causal) against its plain version (limit
    3e-2), timed beside SDPA in bf16 on the same inputs (K/V expanded to the
    16 heads); its bound is the flops at 989 TFLOP/s of bf16."""
    b, t, kh, g, d = LM_BATCH, LM_PREFILL, 8, 2, 128
    q = cuda_normal(rng, (b, t, kh, g, d), dtype=BF16)
    k, v = (cuda_normal(rng, (b, t, kh, d), dtype=BF16) for _ in range(2))
    out = fa_ops.flash_attention(q, k, v, causal=True)
    ref = gqa_plain(q, k, v, causal=True, q_offset=0)
    torch.testing.assert_close(out.float(), ref.float(), **BF16_TOL)
    visible = t * (t + 1) // 2
    nbytes, flops = 2 * (2 * q.numel() + k.numel() + v.numel()), 4.0 * b * kh * g * visible * d
    tb, by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
    log(f"flash_attention bf16 bound at the qwen3 prefill shape: {tb:.4f} ms ({by}: "
        f"{flops / 1e9:.1f} GFLOP at 989 TFLOP/s); shared memory per CTA "
        f"{smem_bytes(d, d, BF16)} bytes")
    qs = q.reshape(b, t, kh * g, d).transpose(1, 2)
    ks, vs = (z.repeat_interleave(g, dim=2).transpose(1, 2) for z in (k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    return dict(
        shape=f"q ({b}, {t}, {kh}, {g}, {d}) bf16, k/v ({b}, {t}, {kh}, {d}), causal",
        max_abs_err=float((out.float() - ref.float()).abs().max()),
        ms=time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True), 20),
        device_ms=graph_ms(lambda: fa_ops.flash_attention(q, k, v, causal=True), 20),
        plain_ms=time_ms(lambda: gqa_plain(q, k, v, causal=True, q_offset=0), 5),
        bound_ms=tb, bound_by=by,
        library_ms=time_ms(sdpa, 20), library_device_ms=graph_ms(sdpa, 20))


def host_us(fn, reps: int = 1000) -> float:
    """Host time of one call, in µs: ``reps`` calls in a row on the host
    clock, after ten to warm up (the device is synchronised before and
    after, outside the timing)."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / reps * 1e6


def g_split(rng) -> dict:
    """accumulate_blocked's host cost at nmf's round (4 rows of 1,141,376
    float32), split into the parts of its launch path, each called 1,000
    times in a row (host µs per call): the library lookup, a device context,
    the stream, the row checks, the ctypes pointer array, the output's
    allocation, the launch counter, the ctypes call that launches the kernel,
    and whole calls.  Imports what it times when it runs, so that a copy of
    this script beside an older package times that package's launch path."""
    import ctypes

    from repro_torch.kernels.accumulate import kernel as acc_kernel

    v = NMF_ROUND
    rows = [cuda_normal(rng, (v,)) for _ in range(N_THREADS)]
    out = torch.empty(v, device="cuda")
    sigs = acc_kernel._SIGNATURES
    lib = build.library("accumulate", sigs)
    ptrs = (ctypes.c_void_p * N_THREADS)(*[r.data_ptr() for r in rows])
    stream = torch.cuda.current_stream().cuda_stream

    x = torch.stack(rows)

    def device_context():
        with torch.cuda.device(out.device):
            pass

    parts = {
        "build.library": lambda: build.library("accumulate", sigs),
        "torch.cuda.device enter+exit": device_context,
        "build.stream_of": lambda: build.stream_of(out),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream,
        "torch.cuda.current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(0).cuda_stream,
        "torch.cuda.current_device": torch.cuda.current_device,
        "rows: contiguous, data_ptr": lambda: [r.contiguous().data_ptr() for r in rows],
        "_rows_of": lambda: acc_kernel._rows_of(rows),
        "ctypes pointer array": lambda: (ctypes.c_void_p * N_THREADS)(
            *[r.data_ptr() for r in rows]),
        "torch.empty(v)": lambda: torch.empty(v, device=out.device),
        "torch.empty_like(row)": lambda: torch.empty_like(rows[0]),
        "LaunchCounter.add": acc_kernel.launches.add,
        "ctypes call (the launch)": lambda: lib.accumulate_rows(
            0, ptrs, None, 0, N_THREADS, v, out.data_ptr(), 1, stream),
        "accumulate_blocked(rows)": lambda: acc_kernel.accumulate_blocked(rows),
        "torch.sum(x, 0)": lambda: torch.sum(x, dim=0),
    }
    if hasattr(acc_kernel, "accumulate_rows_unchecked"):
        parts["accumulate_rows_unchecked(rows)"] = \
            lambda: acc_kernel.accumulate_rows_unchecked(rows)
    split = {name: host_us(fn) for name, fn in parts.items()}
    log(f"accumulate_blocked host split at nmf's round ({N_THREADS} x {v} f32), us per "
        "call over 1,000 calls:", json.dumps(split))
    return split


def h_split(rng) -> dict:
    """sparse_scatter_add's host cost at pagerank's unfused round (4 rows of
    1,211,904 int32/float32 pairs into 4,847,571), split into the parts of
    its launch path, each called 200 times in a row (host µs per call; few
    enough that the launches queued never fill the device's queue):
    the output's allocation, the stream, the ctypes call that makes the
    cooperative launch, and whole calls, public and through the
    accumulator's entry, beside one index_add_ into fresh zeros.  Imports
    what it times when it runs, as g_split does."""
    from repro_torch.kernels.sparse_update import kernel as h_kernel

    v = LJ_VERTICES
    pairs = [blocked_topk_sparsify(rng_sparse(rng, (v,), 0.3), v // 4) for _ in range(N_THREADS)]
    idx = torch.stack([p.idx for p in pairs])
    vals = torch.stack([p.vals for p in pairs])
    acc = torch.empty(v, device="cuda")
    lib = build.library("scatter_add", h_kernel._SIGNATURES)
    stream = torch.cuda.current_stream().cuda_stream
    flat_i, flat_v = idx.reshape(-1), vals.reshape(-1)
    parts = {
        "torch.empty(v)": lambda: torch.empty(v, device="cuda"),
        "torch.cuda.current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(0).cuda_stream,
        "ctypes call (the cooperative launch)": lambda: lib.sparse_scatter_add_rows(
            0, 0, idx.data_ptr(), vals.data_ptr(), N_THREADS, idx.shape[1], v,
            acc.data_ptr(), None, stream),
        "sparse_scatter_add": lambda: h_kernel.sparse_scatter_add(idx, vals, v),
        "zeros + index_add_": lambda: torch.zeros(v, device="cuda").index_add_(
            0, flat_i, flat_v)}
    if hasattr(h_kernel, "sparse_scatter_add_unchecked"):
        parts["sparse_scatter_add_unchecked"] = \
            lambda: h_kernel.sparse_scatter_add_unchecked(idx, vals, v)
    split = {name: host_us(fn, 200) for name, fn in parts.items()}
    log(f"sparse_scatter_add host split at pagerank's unfused round ({N_THREADS} x "
        f"{idx.shape[1]} pairs), us per call over 200 calls:", json.dumps(split))
    return split


def b_split(rng) -> dict:
    """topk_compress's host cost at logreg's unfused shape (x (512,) f32,
    block 512, k 32: the argmax body) and pagerank's (the bitonic body),
    split into the parts of its launch path, each called 1,000 times in a
    row (host µs per call): the outputs' allocation, the stream, the
    ctypes call that launches the argmax body, and whole calls of either
    body beside torch.topk of the blocked magnitudes.  Imports what it
    times when it runs, as g_split does."""
    from repro_torch.kernels.topk_compress import ops as b_ops

    x = rng_sparse(rng, (LR_FEATURES,), 0.3)
    lib = build.library("topk_compress", b_ops._SIGNATURES)
    idx = torch.empty(LR_K, dtype=torch.int32, device="cuda")
    vals = torch.empty(LR_K, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    mags = x.abs()[None]
    nb, be, pb = block_layout(LJ_VERTICES, LJ_VERTICES // 4)
    xp = rng_sparse(rng, (LJ_VERTICES,), 0.3)
    parts = {
        "torch.empty x 2": lambda: (torch.empty(LR_K, dtype=torch.int32, device="cuda"),
                                    torch.empty(LR_K, device="cuda")),
        "torch.cuda.current_stream(index).cuda_stream":
            lambda: torch.cuda.current_stream(0).cuda_stream,
        "ctypes call (the argmax launch)": lambda: lib.topk_compress(
            0, x.data_ptr(), idx.data_ptr(), vals.data_ptr(), LR_FEATURES, LR_FEATURES, LR_K,
            0, None, stream),
        "topk_compress argmax, logreg": lambda: b_ops.topk_compress(
            x, k_per_block=LR_K, block_v=LR_FEATURES, method="argmax"),
        "torch.topk, logreg": lambda: torch.topk(mags, LR_K, dim=1),
        "topk_compress bitonic, pagerank": lambda: b_ops.topk_compress(
            xp, k_per_block=pb, block_v=be, method="bitonic")}
    split = {name: host_us(fn, 1000 if "pagerank" not in name else 200)
             for name, fn in parts.items()}
    log(f"topk_compress host split (logreg's x ({LR_FEATURES},), k {LR_K}; pagerank's "
        f"{nb} blocks), us per call:", json.dumps(split))
    return split


def time_g_in_pagerank(samples: list):
    """Wrap the accumulator's entry to accumulate_blocked so that each call
    in an app run appends to ``samples``: the host s of the call alone, CUDA
    events recorded just before and after it, and, timed in the same thread
    just before it, the host s of three of its parts (allocating the output,
    asking for the stream, a ctypes call that launches nothing).  Returns a
    function that puts the entry back."""
    import repro_torch.core.accumulator as acc_mod
    from repro_torch.kernels.accumulate import kernel as acc_kernel

    real = acc_mod.accumulate_rows
    lib = build.library("accumulate", acc_kernel._SIGNATURES)

    def timed(rows):
        parts = []
        for part in (lambda: torch.empty_like(rows[0]),
                     lambda: torch.cuda.current_stream(rows[0].get_device()).cuda_stream,
                     lambda: lib.repro_cuda_error_string(0)):
            t0 = time.perf_counter()
            part()
            parts.append(time.perf_counter() - t0)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        t0 = time.perf_counter()
        out = real(rows)
        host = time.perf_counter() - t0
        end.record()
        samples.append((host, start, end, parts))
        return out

    acc_mod.accumulate_rows = timed
    return lambda: setattr(acc_mod, "accumulate_rows", real)


def bf16_sparse_round(rng, counts: dict) -> None:
    """One bf16 SPARSE round of 4 contributions through DAddAccumulator at
    pagerank's V (k = V/4, blocks of 1,024), fused (one fused_topk_scatter
    launch) and unfused (topk_compress per contribution, then the pairs
    added in bf16, as the JAX package adds them), each held bit-exact
    against the same round's plain path (the stable-sort selection)."""
    import threading

    from repro_torch.core import AccumMode, DAddAccumulator, GlobalStore
    from repro_torch.core.sparse import blocked_topk_accumulate

    v, k = LJ_VERTICES, LJ_VERTICES // 4
    vecs = [rng_sparse(rng, (v,), 0.3).to(BF16) for _ in range(N_THREADS)]

    def one_round(fused):
        store = GlobalStore(device="cuda")
        store.new_array("out", (v,), BF16)
        acc = DAddAccumulator(store, "out", N_THREADS, N_NODES, AccumMode.SPARSE, k=k,
                              fused=fused)
        threads = []
        for i, vec in enumerate(vecs):      # contributions arrive in list order
            threads.append(threading.Thread(target=acc.accumulate, args=(vec,)))
            threads[-1].start()
            while acc._count < i + 1 and i + 1 < N_THREADS:
                time.sleep(0.001)
        for th in threads:
            th.join()
        return store.get("out")

    for fused, expected in ((True, {"fused_topk_scatter": 1}),
                            (False, {"topk_compress_bitonic": N_THREADS,
                                     "fused_topk_scatter": 0})):
        label = f"bf16 sparse round {'fused' if fused else 'unfused'}"
        got, launched = run_app(label, counts, lambda: one_round(fused))
        expect_launches(label, launched, expected)
        ref = blocked_topk_accumulate(torch.stack(vecs), k, fused=fused, impl="torch")
        if got.dtype != BF16 or not torch.equal(got, ref):
            raise AssertionError(f"{label}: differs from its plain path")
    log(f"bf16 sparse rounds at V={v}, k={k}: fused and unfused bit-exact with their "
        "plain paths")


def check_assign(pts, ctr, a, dist, pa, pd) -> None:
    """Equal assignments except where the two best d² are within 1e-5
    relative (the sums run in other orders); dist² within rtol 1e-5, with an
    absolute margin of 1e-6·max‖p‖² (the expanded formula rounds relative to
    ‖p‖² + ‖c‖², so a distance near zero carries that much noise)."""
    diff = a.long() != pa.long()
    if bool(diff.any()):
        d2 = ((pts[diff, None, :] - ctr[None]) ** 2).sum(-1)
        two = torch.topk(d2, 2, dim=1, largest=False).values
        gap = (two[:, 1] - two[:, 0]) / two[:, 1].abs().clamp_min(1e-30)
        if bool((gap > 1e-5).any()):
            raise AssertionError(f"kmeans_assign: {int(diff.sum())} assignments "
                                 "differ beyond the tie margin")
    torch.testing.assert_close(dist, pd, rtol=1e-5,
                               atol=1e-6 * float((pts * pts).sum(1).max()))


def cuda_normal(rng, shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).cuda().to(dtype)


def ptxas_lines(log: str, marker: str) -> list:
    """The -Xptxas -v lines (registers, spills, stack) of each kernel whose
    mangled name contains ``marker``."""
    found, name = [], None
    for line in log.splitlines():
        entry = re.search(r"entry function '(\S+)'", line)
        if entry:
            name = entry.group(1) if marker in entry.group(1) else None
        elif name and ("registers" in line or "spill" in line):
            found.append(f"{name}: {line.strip()}")
    return found


def check_flash(rng) -> dict:
    """flash_attention against its plain version: test_kernels.py's four
    sweep shapes, the edges of the kernel's tiling (head dims 20, 80 and
    192/128; T > S with S no multiple of the KV tile; head dim 80
    non-causal; S one past a multiple of 64, so that the last KV tile
    holds one key, causal and not) and, on the GQA layout, q_offset with T
    != S, a decode-shaped call (T = 1, q_offset = S - 1), the qwen3-1.7b
    prefill shape at batch 1, and G 8 non-causal with T > S and S one past a
    tile (the vlm's cross-attention), each in fp32 and bf16; then the
    qwen3-1.7b prefill shape (B 4, T 2048, KH 8, G 2, d 128) in fp32, timed
    there beside SDPA on the same inputs (K/V expanded to the 16 heads)."""
    def held(out, ref, dtype, what):
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                                   msg=lambda m: f"flash_attention {what}: {m}")

    for dtype in FLASH_TOL:
        for bh, t, s, d, dv, causal in [(2, 128, 128, 64, 64, True), (1, 96, 160, 32, 16, False),
                                        (3, 64, 64, 128, 128, True), (1, 17, 33, 16, 16, True),
                                        (2, 50, 70, 20, 20, True), (2, 130, 130, 80, 80, True),
                                        (2, 100, 150, 192, 128, False),
                                        (1, 200, 77, 64, 64, True), (1, 200, 77, 128, 128, False),
                                        (2, 130, 130, 80, 80, False), (2, 150, 129, 128, 128, False),
                                        (1, 129, 129, 128, 128, True)]:
            q, k, v = (cuda_normal(rng, sh, dtype=dtype) for sh in ((bh, t, d), (bh, s, d),
                                                                    (bh, s, dv)))
            held(flash_attention_bhsd(q, k, v, causal=causal),
                 attention_bhsd_ref(q, k, v, causal=causal), dtype, (bh, t, s, d, dv, dtype))
        for b, t, s, kh, g, q_offset, causal in [
                (2, 130, 200, 4, 2, 70, True), (2, 1, 300, 8, 2, 299, True),
                (1, LM_PREFILL, LM_PREFILL, 8, 2, 0, True), (1, 300, 193, 2, 8, 0, False),
                (1, LM_PREFILL, VLM_VISION_TOKENS, 8, 8, 0, False)]:
            q = cuda_normal(rng, (b, t, kh, g, 128), dtype=dtype)
            k, v = (cuda_normal(rng, (b, s, kh, 128), dtype=dtype) for _ in range(2))
            held(fa_ops.flash_attention(q, k, v, causal=causal, q_offset=q_offset),
                 gqa_plain(q, k, v, causal=causal, q_offset=q_offset), dtype,
                 f"GQA {(b, t, s, kh, g)} q_offset={q_offset} causal={causal} {dtype}")

    return flash_prefill(rng, "qwen3-1.7b", 8, 2, 128)


def flash_prefill(rng, arch: str, kh: int, g: int, d: int, dv: int = None,
                  dtype: torch.dtype = torch.float32, s: int = None,
                  causal: bool = True, scaled: bool = False) -> dict:
    """flash_attention at ``arch``'s prefill shape (B 4, T 2048, KH, G, dk
    ``d``, dv ``dv`` or ``d``, S keys ``s`` or T, causal or not) in
    ``dtype``: held to its plain version at FLASH_TOL (and, under ``scaled``,
    in bf16, to limits scaled to the output: ``bf16_held_scaled``), timed a
    call and by graph replay beside the plain version and SDPA on the same
    inputs (K/V expanded to the KH x G heads; where SDPA refuses dk != dv,
    ``library_ms`` is None)."""
    b, t, dv, s = LM_BATCH, LM_PREFILL, dv or d, s or LM_PREFILL
    mask = "causal" if causal else "non-causal"
    q = cuda_normal(rng, (b, t, kh, g, d), dtype=dtype)
    k = cuda_normal(rng, (b, s, kh, d), dtype=dtype)
    v = cuda_normal(rng, (b, s, kh, dv), dtype=dtype)
    out = fa_ops.flash_attention(q, k, v, causal=causal)
    ref = gqa_plain(q, k, v, causal=causal, q_offset=0)
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"flash_attention at the {arch} prefill shape "
                                             f"({dtype}): {m}")
    max_abs_err = float((out.float() - ref.float()).abs().max())
    del ref
    if scaled and dtype == BF16:
        bf16_held_scaled(out, q, k, v, causal, f"{arch} (S {s}, {mask})")
    del out
    # the (query, key) pairs each head scores (causal with S = T: the triangle)
    visible = t * (t + 1) // 2 if causal else t * s
    size = q.element_size()
    nbytes = size * (q.numel() + k.numel() + v.numel() + q.numel() // d * dv)
    flops = 2.0 * b * kh * g * visible * (d + dv)    # q.k and p.v over the visible pairs
    if dtype == torch.float32:
        # the fp32 body does each product as three TF32 products on the
        # tensor cores (3xTF32): its bound; the fp32 pipes' is printed beside it
        tb, by = bound_ms(nbytes, 3 * flops, TF32_FLOPS_PER_S)
        fp32_tb, _ = bound_ms(nbytes, flops)
        rates = (f"3xTF32: 3 x {flops / 1e9:.1f} GFLOP at 495 TFLOP/s on the tensor cores, "
                 f"the bound recorded), {fp32_tb:.4f} ms (the flops on the fp32 pipes at 67 "
                 "TFLOP/s)")
    else:
        tb, by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        rates = f"{flops / 1e9:.1f} GFLOP at 989 TFLOP/s of bf16)"
    log(f"flash_attention {DTYPE_NAMES[dtype]} bounds at the {arch} prefill shape "
        f"(S {s}, {mask}): {tb:.4f} "
        f"ms ({by}; {rates}, bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms; shared memory "
        f"per CTA {smem_bytes(d, dv, dtype)} bytes")
    qs = q.reshape(b, t, kh * g, d).transpose(1, 2)
    ks, vs = (x.repeat_interleave(g, dim=2).transpose(1, 2) for x in (k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

    try:
        sdpa()
    except RuntimeError as e:                        # no SDPA backend for these head dims
        log(f"SDPA at the {arch} prefill shape ({DTYPE_NAMES[dtype]}, dk {d}, dv {dv}) "
            f"refused: {e}")
        library_ms = library_device_ms = None
    else:
        library_ms, library_device_ms = time_ms(sdpa, 20), graph_ms(sdpa, 20)
    return dict(
        shape=f"q ({b}, {t}, {kh}, {g}, {d}) {DTYPE_NAMES[dtype]}, k ({b}, {s}, {kh}, {d}), "
              f"v ({b}, {s}, {kh}, {dv}), {mask}",
        max_abs_err=max_abs_err,
        ms=time_ms(lambda: fa_ops.flash_attention(q, k, v, causal=causal), 20),
        device_ms=graph_ms(lambda: fa_ops.flash_attention(q, k, v, causal=causal), 20),
        plain_ms=time_ms(lambda: gqa_plain(q, k, v, causal=causal, q_offset=0), 5),
        bound_ms=tb, bound_by=by, library_ms=library_ms, library_device_ms=library_device_ms)


def bf16_held_scaled(out, q, k, v, causal: bool, what: str) -> None:
    """The bf16 body's output held to the fp32 plain version on the same bf16
    inputs, at limits scaled to the output (FLASH_TOL's 3e-2 is about one
    typical output where each query averages over ~1,600 keys): the error's
    rms within 2^-8 of the output's rms (bf16 rounds to 2^-9 of a value;
    a tail key dropped or a tile of padding let in moves the output by ~1%),
    and, non-causal, its max within 0.1 std of the output (causal, the first
    rows average a few values of v, outputs up to ~3 whose bf16 half ulp,
    0.0078, is about 0.8 of that limit)."""
    ref = gqa_plain(q.float(), k.float(), v.float(), causal=causal, q_offset=0)
    err = out.float() - ref
    rms_rel = float(err.square().mean().sqrt() / ref.square().mean().sqrt())
    max_err, std = float(err.abs().max()), float(ref.std())
    del ref, err
    log(f"flash_attention bf16 at the {what} against the fp32 plain version: error rms "
        f"{rms_rel:.4e} of the output's (limit {2 ** -8:.4e}), max |err| {max_err:.4e} "
        f"against 0.1 std(out) {0.1 * std:.4e}" + ("" if causal else " (the limit)"))
    if rms_rel > 2 ** -8 or (not causal and max_err > 0.1 * std):
        raise AssertionError(f"flash_attention bf16 at the {what}: error rms {rms_rel:.4e} of "
                             f"the output's, max |err| {max_err:.4e} against 0.1 std(out) "
                             f"{0.1 * std:.4e}")


def ssd_inputs(rng, b, t, h, p, g, n):
    """xbar, a, B, C as ops.ssd makes them from x, dt, A_log (A_log as
    init_mamba2 sets it; dt a softplus, as mamba2_forward makes it)."""
    x = cuda_normal(rng, (b, t, h, p), 0.5)
    dt = torch.nn.functional.softplus(cuda_normal(rng, (b, t, h)))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    a = (dt * -torch.exp(a_log)).float()
    return x * dt[..., None], a, cuda_normal(rng, (b, t, g, n), 0.3), \
        cuda_normal(rng, (b, t, g, n), 0.3)


def ssd_flops(b, t, h, p, n, q) -> float:
    """Per chunk and head: the scores and their product with xbar over the
    causal (row, key) pairs, the carried-state term and the state update."""
    pairs = q * (q + 1) // 2
    return (2.0 * pairs * (n + p) + 4.0 * q * n * p) * (t // q) * b * h


def check_ssd(rng) -> dict:
    """ssd_scan against its plain version (the chunked algorithm):
    test_kernels.py's shapes at chunk 8/16/32, the edges of the kernel's
    tiles (N 12 / P 20 and N 13 / P 7 with H/G 2, a chain of 64 chunks of 8),
    two calls in a row and a CUDA-graph replay bit-equal to an eager call,
    then the mamba2-2.7b prefill shape (b 4, T 2048, H 80, P 64, G 1, N 128,
    chunk 128), timed there per call and by graph replay.  Its bound is the
    3xTF32 tensor-core one (the fp32 pipes' printed beside it)."""
    for chunk in (8, 16, 32):
        xbar, a, bm, cm = ssd_inputs(rng, 2, 64, 4, 8, 2, 16)
        torch.testing.assert_close(ssd_scan(xbar, a, bm, cm, chunk=chunk),
                                   ssd_scan_plain(xbar, a, bm, cm, chunk)[0], **SSD_TOL)
    for b, t, h, p, g, n, q in [(2, 256, 4, 20, 2, 12, 16), (2, 256, 4, 7, 2, 13, 32),
                                (2, 512, 4, 8, 2, 16, 8)]:
        xbar, a, bm, cm = ssd_inputs(rng, b, t, h, p, g, n)
        torch.testing.assert_close(ssd_scan(xbar, a, bm, cm, chunk=q),
                                   ssd_scan_plain(xbar, a, bm, cm, q)[0], **SSD_TOL,
                                   msg=lambda m: f"ssd_scan at {(b, t, h, p, g, n, q)}: {m}")
    return ssd_prefill(rng, "mamba2-2.7b", 80, 64, 1, 128, 128)


def ssd_prefill(rng, arch: str, h: int, p: int, g: int, n: int, q: int) -> dict:
    """ssd_scan at ``arch``'s prefill shape (b 4, T 2048, H, P, G, N, chunk):
    held to its plain version, two calls in a row and a CUDA-graph replay
    bit-equal to an eager call, timed a call and by graph replay.  Its
    bound is the 3xTF32 tensor-core one (the fp32 pipes' printed beside
    it)."""
    b, t = LM_BATCH, LM_PREFILL
    xbar, a, bm, cm = ssd_inputs(rng, b, t, h, p, g, n)
    y = ssd_scan(xbar, a, bm, cm, chunk=q)
    ref = ssd_scan_plain(xbar, a, bm, cm, q)[0]
    torch.testing.assert_close(y, ref, **SSD_TOL,
                               msg=lambda m: f"ssd_scan at the {arch} prefill shape: {m}")
    if not torch.equal(ssd_scan(xbar, a, bm, cm, chunk=q), y):
        raise AssertionError(f"ssd_scan at the {arch} shape: two calls in a row differ")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ssd_scan(xbar, a, bm, cm, chunk=q)
    for _ in range(2):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(replayed, y):
            raise AssertionError(f"ssd_scan at the {arch} shape: a CUDA-graph replay differs "
                                 "from the eager call")
    del graph, replayed
    flops = ssd_flops(b, t, h, p, n, q)
    nbytes = 4 * (2 * xbar.numel() + a.numel() + bm.numel() + cm.numel())
    # each product is three TF32 products on the tensor cores (3xTF32): the
    # bound recorded; the fp32 pipes' is printed beside it
    tb, by = bound_ms(nbytes, 3 * flops, TF32_FLOPS_PER_S)
    fp32_tb, _ = bound_ms(nbytes, flops)
    log(f"ssd_scan bounds at the {arch} prefill shape: {tb:.4f} ms ({by}; 3xTF32: 3 x "
        f"{flops / 1e9:.1f} GFLOP at 495 TFLOP/s), {fp32_tb:.4f} ms (the flops on the fp32 "
        f"pipes at 67 TFLOP/s), bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"({nbytes / 1e6:.1f} MB); shared memory per CTA {ssd_smem_bytes(q, p, n)} bytes")
    return dict(
        shape=f"xbar ({b}, {t}, {h}, {p}) f32, B/C ({b}, {t}, {g}, {n}), chunk {q}",
        max_abs_err=float((y - ref).abs().max()),
        ms=time_ms(lambda: ssd_scan(xbar, a, bm, cm, chunk=q), 20),
        device_ms=graph_ms(lambda: ssd_scan(xbar, a, bm, cm, chunk=q), 20),
        plain_ms=time_ms(lambda: ssd_scan_plain(xbar, a, bm, cm, q), 5),
        bound_ms=tb, bound_by=by, fp32_bound_ms=fp32_tb, library_ms=None)


def check_zamba2_shapes(rng) -> dict:
    """E and F at zamba2-2.7b's prefill shapes: attention MHA (G 1) at head
    dim 80 (the fp32 body pads dk to 96 and takes its 128 instance), the SSD
    scan at N 64 (F's tiles were sized at mamba2's 128)."""
    return {"flash_attention@zamba2-2.7b": flash_prefill(rng, "zamba2-2.7b", 32, 1, 80),
            "ssd_scan@zamba2-2.7b": ssd_prefill(rng, "zamba2-2.7b", 80, 64, 1, 64, 128)}


def check_moe_shapes(rng) -> dict:
    """E at the moe family's prefill shapes: moonshot-v1-16b-a3b's MHA (16
    heads, G 1, head dim 128) in fp32 and bf16, and deepseek-v3-671b's MLA
    (128 heads, G 1, dk = nope 128 + rope 64 = 192 against dv 128: the
    wrapper takes its 256 instance) in fp32."""
    return {"flash_attention@moonshot-v1-16b-a3b": flash_prefill(
                rng, "moonshot-v1-16b-a3b", 16, 1, 128),
            "flash_attention_bf16@moonshot-v1-16b-a3b": flash_prefill(
                rng, "moonshot-v1-16b-a3b", 16, 1, 128, dtype=BF16),
            "flash_attention@deepseek-v3-671b": flash_prefill(
                rng, "deepseek-v3-671b", 128, 1, 192, dv=128)}


def check_vlm_audio_shapes(rng) -> dict:
    """E off its causal path, at the shapes the vlm and audio families give
    it: llama-3.2-vision-90b's self attention (64 query heads over 8 KV
    heads, G 8, head dim 128, causal) and its cross-attention (the 2,048
    text queries over the 1,601 vision keys, non-causal: the last 64-key
    tile holds one key), each in fp32 and bf16 (the bf16 prefill runs both),
    the bf16 ones also held to limits scaled to the output, and
    hubert-xlarge's MHA (16 heads at head dim 80, non-causal)."""
    vlm = "llama-3.2-vision-90b"
    return {"flash_attention@llama-3.2-vision-90b self": flash_prefill(rng, vlm, 8, 8, 128),
            "flash_attention_bf16@llama-3.2-vision-90b self": flash_prefill(
                rng, vlm, 8, 8, 128, dtype=BF16, scaled=True),
            "flash_attention@llama-3.2-vision-90b cross": flash_prefill(
                rng, vlm, 8, 8, 128, s=VLM_VISION_TOKENS, causal=False),
            "flash_attention_bf16@llama-3.2-vision-90b cross": flash_prefill(
                rng, vlm, 8, 8, 128, dtype=BF16, s=VLM_VISION_TOKENS, causal=False,
                scaled=True),
            "flash_attention@hubert-xlarge": flash_prefill(rng, "hubert-xlarge", 16, 1, 80,
                                                           causal=False)}


def check_dense_shapes(rng) -> dict:
    """E at the dense family's two GQA shapes no other row holds, causal, in
    fp32 and bf16 (the bf16 ones also to limits scaled to the output):
    starcoder2-3b's 24 query heads over 2 KV heads (G 12) and qwen3-4b's 32
    over 8 (G 4), head dim 128; G is the kernel's own index (``head /
    group``), not folded away by the wrapper.  qwen2-72b's 64 over 8 is the
    vlm's self shape (check_vlm_audio_shapes)."""
    out = {}
    for arch, kh, g in (("starcoder2-3b", 2, 12), ("qwen3-4b", 8, 4)):
        out[f"flash_attention@{arch}"] = flash_prefill(rng, arch, kh, g, 128)
        out[f"flash_attention_bf16@{arch}"] = flash_prefill(rng, arch, kh, g, 128, dtype=BF16,
                                                            scaled=True)
    return out


def f_timings(rng) -> dict:
    """ssd_scan at the mamba2-2.7b prefill shape in float32 and bfloat16 at
    chunks 128 and 256: ms a call (CUDA events, median of 20) and the device
    time by CUDA-graph replay (20 replays).  Imports what it times when it
    runs, as g_split does, so that a copy of this script beside an older
    package times that package's kernel (parent, change, change, parent)."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan as scan

    b, t, h, p, g, n = LM_BATCH, LM_PREFILL, 80, 64, 1, 128
    xbar, a, bm, cm = ssd_inputs(rng, b, t, h, p, g, n)
    out = {}
    for dtype, q in ((torch.float32, 128), (BF16, 128), (torch.float32, 256), (BF16, 256)):
        xq, bq, cq = (z.to(dtype) for z in (xbar, bm, cm))
        out[f"{DTYPE_NAMES[dtype]} chunk {q}"] = dict(
            ms=time_ms(lambda: scan(xq, a, bq, cq, chunk=q), 20),
            device_ms=graph_ms(lambda: scan(xq, a, bq, cq, chunk=q), 20))
    log(f"ssd_scan at the mamba2 prefill shape, ms a call and on the device: {json.dumps(out)}")
    return out


def a_timings(rng) -> dict:
    """fused_topk_scatter at pagerank's (x (4, 4,847,571), block 1,024,
    per_block 256) and logreg's (x (4, 512), one block, per_block 32) fused
    shapes in float32 and bfloat16 at density 0.3: ms a call (CUDA events,
    median of 20) and the device time by CUDA-graph replay (20 replays).
    Imports what it times when it runs, as f_timings does, so that a copy of
    this script beside an older package times that package's kernel."""
    from repro_torch.kernels.accumulate.fused_scatter import fused_topk_scatter as fused

    out = {}
    for app, v, k in (("pagerank", LJ_VERTICES, LJ_VERTICES // 4), ("logreg", LR_FEATURES, LR_K)):
        _, be, pb = block_layout(v, k)
        x32 = rng_sparse(rng, (N_THREADS, v), 0.3)
        for dtype in (torch.float32, BF16):
            x = x32.to(dtype)
            out[f"{app} {DTYPE_NAMES[dtype]}"] = dict(
                ms=time_ms(lambda: fused(x, per_block=pb, block_eff=be), 20),
                device_ms=graph_ms(lambda: fused(x, per_block=pb, block_eff=be), 20))
    log(f"fused_topk_scatter at the fused shapes, ms a call and on the device: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# Phase 4: the apps through the host Session
# ---------------------------------------------------------------------------


WALLS: dict = {}     # label -> wall seconds of run_app's last run under it
PEAKS: dict = {}     # label -> peak device memory (GiB) of run_app's last run under it


def run_app(label: str, counts: dict, fn):
    """Run ``fn`` with every launch counter zeroed just before and read just
    after; add the run's launches to ``counts``.  Prints wall time and peak
    device memory, beside what earlier runs still held when it started.  A
    collection first frees the tensors of earlier sessions that only a
    reference cycle kept, so none is freed during the run and lowers its
    peak over what is held."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    build.reset_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    WALLS[label] = wall
    PEAKS[label] = torch.cuda.max_memory_allocated() / 2**30
    launched = build.launch_counts()
    for name, c in launched.items():
        counts[name] = counts.get(name, 0) + c
    log(f"run {label}: wall {wall:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({held / 2**30:.3f} held "
        f"before the run), launches {json.dumps({k: v for k, v in launched.items() if v})}")
    return out, launched


def expect_launches(label: str, launched: dict, expected: dict) -> None:
    for name, n in expected.items():
        if launched.get(name, 0) != n:
            raise AssertionError(f"{label}: {name} launched {launched.get(name, 0)} "
                                 f"times, expected {n}")


def close(a, b, what: str) -> None:
    np.testing.assert_allclose(a, b, err_msg=what, **APP_TOL)


def small_reference_checks() -> None:
    """Each app on the card at a small size against its single-thread
    reference on the CPU — the JAX package's tests hold threads against
    reference with these tolerances (the threaded sums run in another
    order).  Also: pagerank's credit scatter repeats on the card to within
    one fp32 ulp."""
    edges = powerlaw_graph(300, 5, seed=3)
    r, _ = pagerank.fit(edges, 300, iters=ITERS)
    np.testing.assert_allclose(r, pagerank.fit_reference(edges, 300, ITERS, device="cpu"),
                               rtol=1e-4, atol=1e-6, err_msg="pagerank small")
    x, y, _ = logreg_dataset(400, 24, seed=0)
    th, _ = logreg.fit(x, y, iters=ITERS, mode="sparse", k=24)
    np.testing.assert_allclose(th, logreg.fit_reference(x, y, ITERS, device="cpu"),
                               rtol=1e-4, atol=1e-5, err_msg="logreg small")
    xk, _, _ = kmeans_dataset(600, 8, 5, seed=1)
    c, _ = kmeans.fit(xk, 5, iters=6, seed=1, use_kernel=True)
    np.testing.assert_allclose(c, kmeans.fit_reference(xk, 5, 6, 1, device="cpu"),
                               rtol=1e-3, atol=1e-3, err_msg="kmeans small")
    r, _, _ = nmf_dataset(120, 32, 4, seed=2)
    p, q, _ = nmf.fit(r, 4, iters=ITERS, seed=3, mode="auto")
    pr, qr = nmf.fit_reference(r, 4, ITERS, 3, device="cpu")
    np.testing.assert_allclose(nmf.frob_loss(r, p, q), nmf.frob_loss(r, pr, qr, device="cpu"),
                               rtol=1e-2, err_msg="nmf small")      # test_analytics.py:53
    big = torch.from_numpy(powerlaw_graph(200_000, 14, seed=1)).long().cuda()
    ranks = torch.rand(200_000, generator=torch.Generator().manual_seed(SEED)).cuda()
    deg = torch.ones(200_000, device="cuda")
    runs = [pagerank._credits(big[:, 0], big[:, 1], ranks, deg, 200_000) for _ in range(3)]
    ulp = torch.finfo(torch.float32).eps
    for other in runs[1:]:
        torch.testing.assert_close(other, runs[0], rtol=ulp, atol=0.0)
    log("small reference checks: pagerank, logreg (sparse, lossless), kmeans "
        "(kernel), nmf (auto) agree with their CPU references; the credits "
        "scatter repeats to within one fp32 ulp")


def check_credits(edges) -> dict:
    """pagerank's binned credit path at LiveJournal scale, on each of the
    four threads' slices as the host backend hands them out: bin_edges'
    set-up pass (host clock, ended by a synchronize) and binned_credits
    held against the plain pagerank._credits it replaces on the card, to one
    fp32 ulp (the fp64 adds run in another order), both timed by CUDA
    events; the bound is the round's streamed bytes (8 B an edge, w read
    and the credits written: 8 B a vertex).  Thread 0's slice holds
    powerlaw_graph's hub (~44% of its edges into one vertex, whose bin the
    plan splits across CTAs): its row is the kernels line's.  Beside it, on
    thread 0's slice, the fp64 index_add_ alone and the same (dst, w) in
    fp32 through index_add_ and through sparse_scatter_add (timing only).
    None of these launches is counted."""
    dev = torch.device("cuda")
    ulp = torch.finfo(torch.float32).eps
    deg = pagerank._out_degree(torch.from_numpy(edges[:, 0]).to(dev).long(), LJ_VERTICES)
    ranks = (torch.rand(LJ_VERTICES, generator=torch.Generator().manual_seed(SEED)) + 0.5)
    ranks = (ranks / LJ_VERTICES).to(dev)
    w = ranks / deg
    bin_edges(torch.from_numpy(edges[:1024]).to(dev), LJ_VERTICES)   # the library's load
    per_thread = {}
    for tid in range(N_THREADS):
        lo, hi = partition_rows(edges.shape[0], tid, N_THREADS)
        e = torch.from_numpy(edges[lo:hi]).to(dev)
        before = e.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        binned = bin_edges(e, LJ_VERTICES)
        torch.cuda.synchronize()
        setup_ms = (time.perf_counter() - t0) * 1e3
        if not torch.equal(e, before):
            raise AssertionError(f"pagerank_credits: thread {tid}'s slice changed by the binning")
        src, dst = e[:, 0].long(), e[:, 1].long()
        want = pagerank._credits(src, dst, ranks, deg, LJ_VERTICES)
        got = binned_credits(binned, w)
        torch.testing.assert_close(got, want, rtol=ulp, atol=0.0,
                                   msg=lambda m: f"pagerank_credits, thread {tid}: {m}")
        top = int(torch.bincount(dst, minlength=LJ_VERTICES).max())
        t, by = bound_ms(8 * e.shape[0] + 8 * LJ_VERTICES)
        per_thread[tid] = dict(
            shape=f"thread {tid}'s slice: {e.shape[0]} int32 edges ({top} into one vertex; "
                  f"{binned.plan.n_split} split bins, {binned.plan.items.shape[0]} items), "
                  f"V {LJ_VERTICES}",
            max_abs_err=float((got - want).abs().max()),
            ms=time_ms(lambda: binned_credits(binned, w), 10),
            plain_ms=time_ms(lambda: pagerank._credits(src, dst, ranks, deg, LJ_VERTICES), 5),
            setup_ms=setup_ms, bound_ms=t, bound_by=by, library_ms=None)
        if tid == 0:
            w32 = w[src]
            w64 = w32.double()
            times = {
                "fp64 index_add_": time_ms(lambda: torch.zeros(
                    LJ_VERTICES, dtype=torch.float64, device=dev).index_add_(0, dst, w64), 10),
                "fp32 index_add_": time_ms(lambda: torch.zeros(
                    LJ_VERTICES, device=dev).index_add_(0, dst, w32), 10),
                "fp32 sparse_scatter_add": time_ms(
                    lambda: sparse_scatter_add(dst, w32, LJ_VERTICES), 10)}
            kern = sparse_scatter_add(dst, w32, LJ_VERTICES)
            rel = float(((kern.double() - want.double()).abs()
                         / want.double().abs().clamp_min(1e-30)).max())
            log(f"pagerank credits, thread 0 (the hub's slice), ms: {json.dumps(times)}; "
                f"sparse_scatter_add vs fp64 max rel diff {rel:.3e}")
            del w32, w64, kern
        del e, before, binned, src, dst, want, got
    log("pagerank_credits per thread slice (binned kernel vs plain _credits, ms; set-up "
        "pass ms, host clock):", json.dumps(per_thread))
    return per_thread[0]


def check_nmf_init() -> dict:
    """nmf's initial factors at the nmf cell's shape (Netflix's 480,189 users
    x 17,770 movies at rank 64), drawn on the card by ``kernels/nmf_init``
    and by ``nmf._init`` (numpy, the host) on three seeds past 32 bits: bit
    for bit equal, or this raises.  The draw is timed by CUDA events (six
    launches), ``_init`` by the host clock; the bound is the 4 B a value
    written.  Its row is the kernels line's; none of these launches is
    counted."""
    dev = torch.device("cuda")
    n, m, k = NETFLIX_USERS, NMF_COLS, NMF_RANK
    numpy_ms = []
    for seed in (2**31 + 5, 2**33 + 17, 3_141_592_653):
        p, q, done = nmf_init.abs_normals(n, m, k, *nmf_init.seeded(seed), dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want_p, want_q = nmf._init(n, m, k, seed)
        numpy_ms.append((time.perf_counter() - t0) * 1e3)
        if not (int(done) and np.array_equal(p.cpu().numpy().view(np.uint32),
                                             want_p.view(np.uint32))
                and np.array_equal(q.cpu().numpy().view(np.uint32), want_q.view(np.uint32))):
            raise AssertionError(f"nmf_init: seed {seed}'s P0 and Q0 are not _init's")
        del p, q
    stream = nmf_init.seeded(2**31 + 5)
    t, by = bound_ms(4 * (n * k + k * m))
    ms = time_ms(lambda: nmf_init.abs_normals(n, m, k, *stream, dev), 10)
    return dict(shape=f"P0 ({n}, {k}) then Q0 ({k}, {m}) float32, 3 seeds bit-equal to _init",
                max_abs_err=0.0, ms=ms,
                plain_ms=float(np.median(numpy_ms)), bound_ms=t, bound_by=by, library_ms=None)


def check_nmf_products() -> dict:
    """nmf's two products over R at one thread's slice of the nmf cell:
    Netflix's 480,189 users over four threads, 120,047 rows x 17,770 movies,
    R a view from row 1 of a larger matrix (its pitch 71,080 B, 8 mod 16, as
    a slice of the cell's R starts), P and Q at rank 64, all non-negative
    as nmf's are.  Each kernel is held to the fp64 product, its error scaled
    by |A|.|B| (here the product itself) within twice fp32 torch.matmul's
    (TF32 off) or 2^-20, and to its own bits on a second call; each is timed
    by CUDA events beside torch.matmul, the plain path and the library at
    once.  The bound is R's read, 4 B an element.  Returns the kernels
    line's rows; none of these launches is counted."""
    dev = torch.device("cuda")
    n, m, k = NETFLIX_USERS // N_THREADS, NMF_COLS, NMF_RANK
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    r = torch.rand(n + 1, m, generator=gen, device=dev)[1:]
    p = torch.rand(n, k, generator=gen, device=dev)
    q = torch.rand(k, m, generator=gen, device=dev)
    bound, by = bound_ms(4 * n * m)
    rows = {}
    for name, fn, lib, exact in (
            ("nmf_products_rqt", lambda: nmf_products.rqt(r, q), lambda: r @ q.T,
             lambda: torch.cat([blk.double() @ q.double().T for blk in r.split(1 << 14)])),
            ("nmf_products_ptr", lambda: nmf_products.ptr(p, r), lambda: p.T @ r,
             lambda: sum(pb.double().T @ rb.double()
                         for pb, rb in zip(p.split(1 << 14), r.split(1 << 14))))):
        got, want = fn(), exact()
        if not torch.equal(got, fn()):
            raise AssertionError(f"{name}: two calls differ")
        err = float(((got.double() - want).abs() / want).max())
        lib_err = float(((lib().double() - want).abs() / want).max())
        if err > max(2 * lib_err, 2.0 ** -20):
            raise AssertionError(f"{name}: scaled error {err:.3e} past twice torch.matmul's "
                                 f"{lib_err:.3e} (or 2^-20)")
        library_ms = time_ms(lib, 10)
        rows[name] = dict(
            shape=f"R ({n}, {m}) from row 1, pitch {4 * m} B; P ({n}, {k}), Q ({k}, {m}) f32; "
                  f"scaled error {err:.3e} (torch.matmul's {lib_err:.3e})",
            max_abs_err=float((got.double() - want).abs().max()), ms=time_ms(fn, 10),
            plain_ms=library_ms, bound_ms=bound, bound_by=by, library_ms=library_ms)
        del got, want
    log("nmf_products at the nmf cell's thread slice (3xTF32 kernel vs fp32 torch.matmul, "
        "ms):", json.dumps(rows))
    return rows


def logreg_slice_kernels(x: CSRMatrix, y: torch.Tensor, label: str) -> dict:
    """Thread 0's slice of ``x``, as the host backend hands it out, through
    the margin kernel against the plain version (2e-6 on residuals in
    (-1, 1): the fp64 row sums run in another order, the sigmoids are two
    implementations) and the binned kernel with a value an edge against a
    plain fp64 scatter (one fp32 ulp beside the fp64 sums' own rounding),
    each timed by CUDA events beside its plain version, the set-up pass by
    the host clock.  The bounds are each kernel's streamed bytes: the
    margin's 8 B a nonzero and a row, the gradient's 8 B a nonzero, 4 B a
    row and 4 B a feature (the cell's roofline counts).  Returns the
    margin's row of the kernels line, the gradient's numbers beside it."""
    dev = torch.device("cuda")
    rows, features = x.shape
    theta = torch.randn(features, generator=torch.Generator(dev).manual_seed(SEED + 1),
                        device=dev) * 0.1
    lo, hi = partition_rows(rows, 0, N_THREADS)
    part, ys = x[lo:hi], y[lo:hi]
    row_of, cols = part.row_ids(), part.indices.long()
    r = margin_residuals(part, ys, theta)
    err = float((r - margin_residuals_plain(part, ys, theta, row_of)).abs().max())
    if err > 2e-6:
        raise AssertionError(f"logreg_margin, {label}: residuals {err:.3e} from the plain "
                             "version's")
    small = part[:64]                                         # the library's load
    bin_edges(torch.stack([small.row_ids(torch.int32), small.indices], 1), features,
              values=small.values, n_sources=64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pairs = torch.stack([part.row_ids(torch.int32), part.indices], 1)
    binned = bin_edges(pairs, features, values=part.values, n_sources=part.shape[0])
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    del pairs

    def plain_grad():
        terms = r[row_of].double() * part.values.double()
        return torch.zeros(features, dtype=torch.float64, device=dev).index_add_(0, cols, terms)

    want = plain_grad()
    size = torch.zeros_like(want).index_add_(0, cols, (r[row_of].double() * part.values).abs())
    g_err = (binned_credits(binned, r).double() - want).abs()
    eps64 = torch.finfo(torch.float64).eps
    if not bool((g_err <= torch.finfo(torch.float32).eps * want.abs() + 64 * eps64 * size).all()):
        raise AssertionError(f"binned credits with values, {label}: {float(g_err.max()):.3e} "
                             "from the plain fp64 scatter")
    g_err = float(g_err.max())
    del want, size
    t, by = bound_ms(8 * part.nnz + 8 * part.shape[0])
    g_t, _ = bound_ms(8 * part.nnz + 4 * part.shape[0] + 4 * features)
    measured = dict(
        shape=f"{label}, thread 0's slice: {part.shape[0]} rows, {part.nnz} nonzeros over "
              f"{features} features", max_abs_err=err,
        ms=time_ms(lambda: margin_residuals(part, ys, theta), 10),
        plain_ms=time_ms(lambda: margin_residuals_plain(part, ys, theta, row_of), 5),
        bound_ms=t, bound_by=by, library_ms=None,
        grad_ms=time_ms(lambda: binned_credits(binned, r), 10),
        grad_plain_ms=time_ms(plain_grad, 5), grad_bound_ms=g_t, grad_max_abs_err=g_err,
        split_bins=binned.plan.n_split, items=int(binned.plan.items.shape[0]),
        setup_ms=setup_ms)
    log(f"logreg csr, {label}, thread 0's slice ({part.shape[0]} rows, {part.nnz} nonzeros, "
        f"{features} features): margin kernel {measured['ms']:.4f} ms (plain "
        f"{measured['plain_ms']:.4f}, bound {t:.4f}), binned gradient "
        f"{measured['grad_ms']:.4f} ms (plain fp64 scatter {measured['grad_plain_ms']:.4f}, "
        f"bound {g_t:.4f}; {binned.plan.n_split} split bins, {measured['items']} items), "
        f"set-up pass {setup_ms:.2f} ms (host clock); max abs err: residuals {err:.3e}, "
        f"gradient {g_err:.3e}")
    return measured


# the gradient's numbers beside the margin kernel's in the kernels line's
# logreg_margin row (the binned kernel with values, at the cell's slice)
GRAD_KEYS = ("grad_max_abs_err", "grad_ms", "grad_plain_ms", "grad_bound_ms")


def check_logreg_sparse(counts: dict) -> dict:
    """logreg over a CSR design matrix, made on the card by the benchmark's
    generator: both kernels on thread 0's slice (``logreg_slice_kernels``)
    at ``LR_CSR`` and at the benchmark cell's size (``LR_CELL``, whose row
    is the kernels line's: the shape the cell's threads run); then a traced
    4-thread AUTO job at ``LR_CSR`` on the card with its launches
    asserted, held to the CPU's plain path at 1e-6 of max |theta|; the split
    bins are those of the threads' slices binned as the job bins them."""
    from stepbench.generators import sparse_rows
    dev = torch.device("cuda")
    d = sparse_rows.make({"matrix": LR_CELL}, torch.Generator(dev).manual_seed(SEED), dev)
    cell = logreg_slice_kernels(CSRMatrix(d["indptr"], d["indices"], d["values"],
                                          d["n_features"]), d["y"], "the cell's size")
    del d
    torch.cuda.empty_cache()
    d = sparse_rows.make({"matrix": LR_CSR}, torch.Generator(dev).manual_seed(SEED), dev)
    x, y = CSRMatrix(d["indptr"], d["indices"], d["values"], d["n_features"]), d["y"]
    rows = x.shape[0]
    logreg_slice_kernels(x, y, "LR_CSR")

    traced = Session(n_nodes=N_NODES, threads_per_node=THREADS_PER_NODE, trace=True)
    try:
        (th, _), launched = run_app("logreg csr auto", counts, lambda: logreg.fit(
            x, y, iters=ITERS, lr=1.0 / rows, mode="auto", session=traced))
        branches = [sp["args"]["mode"] for sp in
                    traced.tracer.spans("accumulate-round", "accumulate.round")]
    finally:
        traced.tracer.disable()
    expect_launches("logreg csr auto", launched, {
        "logreg_margin": N_THREADS * ITERS, "pagerank_credits": N_THREADS * ITERS,
        "pagerank_bin_histogram": N_THREADS, "pagerank_bin_scatter": N_THREADS})
    th_cpu, _ = logreg.fit(x.to("cpu"), y.cpu(), iters=ITERS, lr=1.0 / rows, device="cpu")
    gap = float(np.abs(th - th_cpu).max() / np.abs(th_cpu).max())
    if gap > 1e-6:
        raise AssertionError(f"logreg csr auto: theta {gap:.3e} of max |theta| from the CPU's")
    split = 0
    for tid in range(N_THREADS):
        part = x[slice(*partition_rows(rows, tid, N_THREADS))]
        split += bin_edges(torch.stack([part.row_ids(torch.int32), part.indices], 1),
                           x.shape[1], values=part.values,
                           n_sources=part.shape[0]).plan.n_split
    log(f"logreg csr auto: branches {collections.Counter(branches)}, split bins "
        f"{split}, theta vs the CPU's plain path "
        f"{gap:.3e} of max |theta|")
    return cell


def session(fused: bool = True) -> Session:
    return Session(backend=HostBackend(N_NODES, THREADS_PER_NODE, fused=fused))


def spmd_session() -> Session:
    return Session(backend=SpmdBackend(mesh=make_mesh((SPMD_POSITIONS,), ("data",))))


def same_wire(label: str, spmd: Session, host: Session) -> None:
    if spmd.wire_traffic() != host.wire_traffic():
        raise AssertionError(f"{label}: SPMD wire {spmd.wire_traffic()} differs from the "
                             f"host run's {host.wire_traffic()}")


NO_ACCUMULATE_KERNEL = {"fused_topk_scatter": 0, "topk_compress_argmax": 0,
                        "topk_compress_bitonic": 0, "sparse_scatter_add": 0,
                        "accumulate_blocked": 0}


def pagerank_launches(threads: int, rounds: int = ITERS) -> dict:
    """The binned credit path's launches in a pagerank job on the card at
    LiveJournal scale: each thread's set-up pass (a slice of ~17 M edges is
    one segment; its 592 bins outnumber a bucket's 128, so it scatters
    twice) and the round's kernel once a thread and round."""
    return {"pagerank_bin_histogram": threads, "pagerank_bin_scatter": 2 * threads,
            "pagerank_credits": threads * rounds}


def run_pagerank_spmd(edges, counts: dict) -> None:
    """pagerank AUTO and SPARSE (k = V/4) through the SPMD backend, each
    against a host run of the same edges: the SPMD split is even, so the
    edges are trimmed to a multiple of the positions first."""
    trimmed = edges[: edges.shape[0] - edges.shape[0] % SPMD_POSITIONS]
    log(f"pagerank spmd: {edges.shape[0] - trimmed.shape[0]} of {edges.shape[0]} edges "
        f"trimmed so that {SPMD_POSITIONS} positions split them evenly")
    k = LJ_VERTICES // 4
    (r_h, s_h), _ = run_app("pagerank auto host (trimmed edges)", counts, lambda: pagerank.fit(
        trimmed, LJ_VERTICES, iters=ITERS, mode="auto", session=session()))
    (r_s, s_s), launched = run_app("pagerank auto spmd", counts, lambda: pagerank.fit(
        trimmed, LJ_VERTICES, iters=ITERS, mode="auto", session=spmd_session()))
    # every round at this scale goes dense: no kernel, the dense (N+1)·V each round
    expect_launches("pagerank auto spmd", launched,
                    {**NO_ACCUMULATE_KERNEL, **pagerank_launches(SPMD_POSITIONS)})
    if s_s.wire_traffic() != ITERS * (SPMD_POSITIONS + 1) * LJ_VERTICES:
        raise AssertionError(f"pagerank auto spmd: wire {s_s.wire_traffic()} is not "
                             "every round dense")
    same_wire("pagerank auto spmd", s_s, s_h)
    close(r_s, r_h, "pagerank auto spmd vs host")
    (r_hs, s_hs), _ = run_app("pagerank sparse host unfused (trimmed edges)", counts,
                              lambda: pagerank.fit(trimmed, LJ_VERTICES, iters=ITERS,
                                                   mode="sparse", k=k, session=session(False)))
    (r_ss, s_ss), launched = run_app("pagerank sparse spmd", counts, lambda: pagerank.fit(
        trimmed, LJ_VERTICES, iters=ITERS, mode="sparse", k=k, session=spmd_session()))
    # one compression per position and one densify for the round
    expect_launches("pagerank sparse spmd", launched,
                    {"topk_compress_bitonic": ITERS * SPMD_POSITIONS,
                     "sparse_scatter_add": ITERS, "fused_topk_scatter": 0,
                     **pagerank_launches(SPMD_POSITIONS)})
    same_wire("pagerank sparse spmd", s_ss, s_hs)
    close(r_ss, r_hs, "pagerank sparse spmd vs host")
    for r in (r_s, r_ss):
        if r.shape != (LJ_VERTICES,) or not np.all(np.isfinite(r)):
            raise AssertionError("pagerank spmd: ranks not finite or of the wrong shape")
    log(f"pagerank spmd: wire auto {s_s.wire_traffic()}, sparse {s_ss.wire_traffic()} "
        f"(== host); max rel diff vs host auto "
        f"{float(np.max(np.abs(r_s - r_h) / np.maximum(np.abs(r_h), 1e-30))):.3e}, sparse "
        f"{float(np.max(np.abs(r_ss - r_hs) / np.maximum(np.abs(r_hs), 1e-30))):.3e}")


def kmeans_seed0_spread(x, labels) -> None:
    """From fit's default init (seed 0): run the plain assignment twice and
    the kernel twice, and print how far the centers of each pair of runs lie
    apart.  Plain against plain shows what the dense accumulator's
    arrival-order fp32 sums alone do to the run; kernel against plain adds
    the two assignments' rounding.  Evidence only: these runs are not held to
    a limit and their launches are not counted."""
    init = np.random.default_rng(0).choice(COV_ROWS, COV_K, replace=False)
    runs = {f"{name}{i}": kmeans.fit(x, COV_K, iters=ITERS, seed=0, use_kernel=kern,
                                     session=session())[0]
            for name, kern in (("plain", False), ("kernel", True)) for i in (1, 2)}
    for c in runs.values():
        if c.shape != (COV_K, COV_FEATURES) or not np.all(np.isfinite(c)):
            raise AssertionError("kmeans seed 0: centers not finite or of the wrong shape")
    diff = {f"{a} vs {b}": float(np.abs(runs[a] - runs[b]).max())
            for a, b in (("plain1", "plain2"), ("kernel1", "kernel2"),
                         ("kernel1", "plain1"), ("kernel2", "plain2"))}
    log(f"kmeans seed 0 (true clusters hit by the init: {len(set(labels[init]))} of "
        f"{COV_K}): max abs center diff {json.dumps(diff)}")


def run_apps(keep: dict) -> dict:
    """Phase 4; ``keep`` receives each app's dataset for the armed phase."""
    counts: dict = {}
    small_reference_checks()

    # -- pagerank, LiveJournal scale ------------------------------------------
    t0 = time.perf_counter()
    edges = powerlaw_graph(LJ_VERTICES, LJ_DEGREE, seed=SEED)
    log(f"pagerank graph: {LJ_VERTICES} vertices, {edges.shape[0]} edges "
        f"(made in {time.perf_counter() - t0:.1f} s)")
    keep["pagerank_credits"] = check_credits(edges)
    traced = Session(n_nodes=N_NODES, threads_per_node=THREADS_PER_NODE, trace=True)
    g_calls: list = []
    restore = time_g_in_pagerank(g_calls)
    try:
        (r_auto, s_auto), launched = run_app("pagerank auto", counts, lambda: pagerank.fit(
            edges, LJ_VERTICES, iters=ITERS, mode="auto", session=traced))
        branches = [sp["args"]["mode"] for sp in
                    traced.tracer.spans("accumulate-round", "accumulate.round")]
    finally:
        restore()
        traced.tracer.disable()
    log(f"pagerank auto: branch per round {branches}, wire {s_auto.wire_traffic()}")
    log("pagerank auto: accumulate_blocked inside the run (4 worker threads), per call: "
        f"host us {[round(h * 1e6, 1) for h, _, _, _ in g_calls]}, CUDA-event ms "
        f"{[round(st.elapsed_time(en), 4) for _, st, en, _ in g_calls]}; just before each "
        "call, host us of torch.empty_like(row), torch.cuda.current_stream(index)"
        f".cuda_stream, a ctypes no-op: {[[round(t * 1e6, 1) for t in p] for *_, p in g_calls]}")
    if len(g_calls) != ITERS:
        raise AssertionError(f"pagerank auto: {len(g_calls)} accumulate_blocked calls timed")
    # every round at this scale takes the dense branch: one fold each
    expect_launches("pagerank auto", launched, {"accumulate_blocked": ITERS,
                                                "fused_topk_scatter": 0,
                                                **pagerank_launches(N_THREADS)})
    if len(branches) != ITERS:
        raise AssertionError(f"pagerank auto: {len(branches)} rounds traced")
    r_ref = pagerank.fit_reference(edges, LJ_VERTICES, ITERS)
    close(r_auto, r_ref, "pagerank auto vs single-thread reference")
    rel = np.abs(r_auto - r_ref) / np.maximum(np.abs(r_ref), 1e-30)
    log(f"pagerank auto vs single-thread reference: max rel diff {rel.max():.3e}")
    keep["pagerank_auto"] = (r_auto, s_auto.wire_traffic(), WALLS["pagerank auto"])
    k = LJ_VERTICES // 4
    (r_f, s_f), launched = run_app("pagerank sparse fused", counts, lambda: pagerank.fit(
        edges, LJ_VERTICES, iters=ITERS, mode="sparse", k=k, session=session(True)))
    expect_launches("pagerank sparse fused", launched, {"fused_topk_scatter": ITERS,
                                                        "sparse_scatter_add": 0,
                                                        **pagerank_launches(N_THREADS)})
    (r_u, s_u), launched = run_app("pagerank sparse unfused", counts, lambda: pagerank.fit(
        edges, LJ_VERTICES, iters=ITERS, mode="sparse", k=k, session=session(False)))
    # unfused: one compression per thread and one scatter launch for all
    # the threads' pairs each round
    expect_launches("pagerank sparse unfused", launched,
                    {"topk_compress_bitonic": ITERS * N_THREADS, "fused_topk_scatter": 0,
                     "sparse_scatter_add": ITERS, **pagerank_launches(N_THREADS)})
    close(r_f, r_u, "pagerank sparse fused vs unfused")
    if s_f.wire_traffic() != s_u.wire_traffic():
        raise AssertionError("pagerank: fused and unfused wire traffic differ")
    for r in (r_auto, r_f, r_u):
        if r.shape != (LJ_VERTICES,) or not np.all(np.isfinite(r)):
            raise AssertionError("pagerank: ranks not finite or of the wrong shape")
    log(f"pagerank sparse: wire {s_f.wire_traffic()} (fused == unfused), "
        f"rank sum auto {r_auto.sum():.6f} sparse {r_f.sum():.6f}")
    run_pagerank_spmd(edges, counts)
    keep["edges"] = edges
    del edges
    bf16_sparse_round(np.random.default_rng(SEED), counts)

    # -- kmeans, Covertype shape ----------------------------------------------
    x, _, labels = kmeans_dataset(COV_ROWS, COV_FEATURES, COV_K, seed=SEED)
    kmeans_seed0_spread(x, labels)
    # Lloyd's starts from one point of each true cluster (the first init seed
    # that gives that): from fit's default seed 0 two centers share a true
    # cluster and split it along a plane of near-tie points, where runs drift
    # apart (kmeans_seed0_spread above prints by how much, and between which
    # runs); without split clusters kernel and plain runs are held to 1e-4
    init_seed = next(s for s in range(100_000) if len(set(labels[
        np.random.default_rng(s).choice(COV_ROWS, COV_K, replace=False)])) == COV_K)
    (c_k, s_k), launched = run_app("kmeans kernel", counts, lambda: kmeans.fit(
        x, COV_K, iters=ITERS, seed=init_seed, use_kernel=True, session=session()))
    expect_launches("kmeans kernel", launched, {"kmeans_assign": ITERS * N_THREADS})
    (c_s, s_s), launched = run_app("kmeans kernel spmd", counts, lambda: kmeans.fit(
        x, COV_K, iters=ITERS, seed=init_seed, use_kernel=True, session=spmd_session()))
    expect_launches("kmeans kernel spmd", launched, {"kmeans_assign": ITERS * SPMD_POSITIONS})
    np.testing.assert_allclose(c_s, c_k, rtol=1e-4, atol=1e-5,
                               err_msg="kmeans spmd vs host (kernel)")
    same_wire("kmeans spmd", s_s, s_k)
    log(f"kmeans spmd: centers vs host max abs diff {np.abs(c_s - c_k).max():.3e}, "
        f"wire {s_s.wire_traffic()} (== host)")
    (c_p, _), _ = run_app("kmeans plain", counts, lambda: kmeans.fit(
        x, COV_K, iters=ITERS, seed=init_seed, use_kernel=False, session=session()))
    np.testing.assert_allclose(c_k, c_p, rtol=1e-4, atol=1e-5,
                               err_msg="kmeans kernel vs plain assignment")
    inertia_k, inertia_p = kmeans.inertia(x, c_k), kmeans.inertia(x, c_p)
    np.testing.assert_allclose(inertia_k, inertia_p, rtol=1e-5,
                               err_msg="kmeans inertia, kernel vs plain")
    log(f"kmeans (init seed {init_seed}): centers kernel vs plain max abs diff "
        f"{np.abs(c_k - c_p).max():.3e}, inertia {inertia_k:.3f} vs {inertia_p:.3f}")
    if c_k.shape != (COV_K, COV_FEATURES) or not np.all(np.isfinite(c_k)):
        raise AssertionError("kmeans: centers not finite or of the wrong shape")
    keep["kmeans"] = (x, init_seed)
    keep["kmeans_init_seed"] = init_seed
    del x

    # -- logreg, sparse gradients ---------------------------------------------
    x, y, _ = logreg_dataset(LR_ROWS, LR_FEATURES, seed=SEED)
    (th_f, s_f), launched = run_app("logreg sparse fused", counts, lambda: logreg.fit(
        x, y, iters=ITERS, lr=LR_STEP, mode="sparse", k=LR_K, session=session(True)))
    expect_launches("logreg sparse fused", launched, {"fused_topk_scatter": ITERS})
    (th_u, s_u), launched = run_app("logreg sparse unfused", counts, lambda: logreg.fit(
        x, y, iters=ITERS, lr=LR_STEP, mode="sparse", k=LR_K, session=session(False)))
    expect_launches("logreg sparse unfused", launched,
                    {"topk_compress_argmax": ITERS * N_THREADS,
                     "sparse_scatter_add": ITERS})
    close(th_f, th_u, "logreg sparse fused vs unfused")
    if s_f.wire_traffic() != s_u.wire_traffic():
        raise AssertionError("logreg: fused and unfused wire traffic differ")
    loss0 = logreg.loss(np.zeros(LR_FEATURES, np.float32), x[:100_000], y[:100_000])
    loss1 = logreg.loss(th_f, x[:100_000], y[:100_000])
    if not (np.all(np.isfinite(th_f)) and loss1 < loss0):
        raise AssertionError(f"logreg: loss {loss1} not below the start's {loss0}")
    log(f"logreg: wire {s_f.wire_traffic()} (fused == unfused), loss {loss0:.4f} -> {loss1:.4f}")
    (th_s, s_s), launched = run_app("logreg sparse spmd", counts, lambda: logreg.fit(
        x, y, iters=ITERS, lr=LR_STEP, mode="sparse", k=LR_K, session=spmd_session()))
    expect_launches("logreg sparse spmd", launched,
                    {"topk_compress_argmax": ITERS * SPMD_POSITIONS,
                     "sparse_scatter_add": ITERS, "fused_topk_scatter": 0})
    close(th_s, th_u, "logreg sparse spmd vs host unfused")
    same_wire("logreg sparse spmd", s_s, s_u)
    log(f"logreg spmd: theta vs host max abs diff {np.abs(th_s - th_u).max():.3e}, "
        f"wire {s_s.wire_traffic()} (== host)")
    keep["logreg"] = (x, y)
    del x, y
    keep["logreg_margin"] = check_logreg_sparse(counts)

    # -- nmf, Netflix's movie columns -----------------------------------------
    keep["nmf_init"] = check_nmf_init()
    keep.update(check_nmf_products())
    products = {"nmf_products": 2 * N_THREADS * ITERS}      # R.Q^T and P^T.R a thread and round
    t0 = time.perf_counter()
    r, _, _ = nmf_dataset(NMF_ROWS, NMF_COLS, NMF_RANK, seed=SEED)
    log(f"nmf: R ({NMF_ROWS}, {NMF_COLS}) f32, {r.nbytes / 1e9:.2f} GB (made in "
        f"{time.perf_counter() - t0:.1f} s): Netflix's {NMF_COLS} movie columns in full, "
        f"its {NETFLIX_USERS} users cut to {NMF_ROWS}; rank {NMF_RANK}, "
        f"Q round {NMF_ROUND} floats")
    (p_a, q_a, s_a), launched = run_app("nmf auto", counts, lambda: nmf.fit(
        r, NMF_RANK, iters=ITERS, seed=NMF_INIT_SEED, mode="auto", session=session()))
    modes = {s_a.accumulator("q_partials").last_mode.value}
    expect_launches("nmf auto", launched, {"accumulate_blocked": ITERS,
                                           "nmf_init": nmf_init.LAUNCHES_A_DRAW, **products})
    (p_d, q_d, s_d), launched = run_app("nmf reduce_scatter", counts, lambda: nmf.fit(
        r, NMF_RANK, iters=ITERS, seed=NMF_INIT_SEED, session=session()))
    expect_launches("nmf reduce_scatter", launched, {"accumulate_blocked": 0,
                                                     "nmf_init": nmf_init.LAUNCHES_A_DRAW,
                                                     **products})
    np.testing.assert_allclose(q_a, q_d, rtol=1e-4, err_msg="nmf Q, auto vs reduce_scatter")
    (p_s, q_s, s_s), launched = run_app("nmf reduce_scatter spmd", counts, lambda: nmf.fit(
        r, NMF_RANK, iters=ITERS, seed=NMF_INIT_SEED, session=spmd_session()))
    expect_launches("nmf reduce_scatter spmd", launched,
                    {**NO_ACCUMULATE_KERNEL, "nmf_init": nmf_init.LAUNCHES_A_DRAW,
                     "nmf_products": 2 * SPMD_POSITIONS * ITERS})
    np.testing.assert_allclose(q_s, q_d, rtol=1e-4, err_msg="nmf Q, spmd vs host")
    same_wire("nmf reduce_scatter spmd", s_s, s_d)
    log(f"nmf spmd: Q vs host max rel diff "
        f"{float(np.max(np.abs(q_s - q_d) / np.abs(q_d))):.3e}, wire {s_s.wire_traffic()} "
        "(== host)")
    if s_a.wire_traffic() != s_d.wire_traffic():
        raise AssertionError("nmf: auto and reduce_scatter wire traffic differ")
    for p, q in ((p_a, q_a), (p_d, q_d), (p_s, q_s)):
        if p.shape != (NMF_ROWS, NMF_RANK) or q.shape != (NMF_RANK, NMF_COLS) or not (
                np.all(np.isfinite(p)) and np.all(np.isfinite(q))):
            raise AssertionError("nmf: factors not finite or of the wrong shape")
    p_r, q_r = nmf.fit_reference(r, NMF_RANK, ITERS, NMF_INIT_SEED)
    loss0 = nmf.frob_loss(r, *nmf._init(NMF_ROWS, NMF_COLS, NMF_RANK, NMF_INIT_SEED))
    loss_a, loss_r = nmf.frob_loss(r, p_a, q_a), nmf.frob_loss(r, p_r, q_r)
    if not loss_a < loss0:
        raise AssertionError(f"nmf: loss {loss_a} not below the start's {loss0}")
    np.testing.assert_allclose(loss_a, loss_r, rtol=1e-2,        # test_analytics.py:53
                               err_msg="nmf loss vs single-thread reference")
    log(f"nmf: branch {modes}, wire {s_a.wire_traffic()} (auto == reduce_scatter), Q auto vs "
        f"reduce_scatter max rel diff {float(np.max(np.abs(q_a - q_d) / np.abs(q_d))):.3e}, "
        f"loss {loss0:.6g} -> {loss_a:.6g} (reference {loss_r:.6g})")
    keep["nmf"] = r
    return counts


# ---------------------------------------------------------------------------
# Phase 5: the apps armed (step.check and step.obs on the card)
# ---------------------------------------------------------------------------


def armed_pair(label: str, counts: dict, make_backend, fit, expected: dict,
               compare, watch: bool = False, lint_extra=None) -> str:
    """``fit(session)`` four times on the same data, in the order unarmed,
    armed (``check=True, record=True``), armed, unarmed, so that a drift
    between runs cancels in the overhead.  Each unarmed run launches
    ``expected``; each armed run launches ``expected`` plus ``lint_extra``
    (what the lint's dry run launches), finds nothing, puts the same
    elements on the wire as the first unarmed run, and ``compare(armed,
    unarmed)`` holds its result to the app tolerance.  Prints the walls and the overhead (the armed runs' sum
    over the unarmed runs'); with ``watch`` a Watchdog polls the first armed
    run.  Returns the first armed session's OpenMetrics page."""
    walls = {True: [], False: []}
    page = None
    for i, armed in enumerate((False, True, True, False)):
        run = f"{label} {'armed' if armed else 'unarmed'} {i + 1}"
        sess = Session(backend=make_backend(), check=armed or None, record=armed or None)
        wd = sess.watchdog(interval_s=0.05) if watch and page is None and armed else None
        if wd is not None:
            wd.start()
        try:
            out, launched = run_app(run, counts, lambda: fit(sess))
        finally:
            if wd is not None:
                wd.stop()
        walls[armed].append(WALLS[run])
        if i == 0:
            out_u, wire_u = out, sess.wire_traffic()
        extra = (lint_extra or {}) if armed else {}
        expect_launches(run, launched, {name: n + extra.get(name, 0)
                                        for name, n in expected.items()})
        if not armed:
            continue
        found = sess.findings()
        if found:
            raise AssertionError(f"{run}: {len(found)} finding(s): "
                                 f"{[f.as_dict() for f in found[:4]]}")
        if sess.wire_traffic() != wire_u:
            raise AssertionError(f"{run}: wire {sess.wire_traffic()} differs from "
                                 f"the unarmed run's {wire_u}")
        compare(out, out_u)
        log(f"{run}: findings 0, benign replicated writes "
            f"{sess.checker.benign_replicated}, wire {sess.wire_traffic()} (== unarmed), "
            f"recorder ring {sess.metrics()['trace']['ring']}")
        if wd is not None:
            if wd.errors:
                raise AssertionError(f"{run}: the watchdog's polls failed: {wd.errors[:3]}")
            log(f"{run}: watchdog {wd.polls} polls at {wd.interval_s} s, anomalies "
                f"{[a.as_dict() | {'dump': None} for a in wd.anomalies]}")
        if page is None:
            page = sess.openmetrics(anomalies=wd.anomalies if wd is not None else None)
        sess.checker.disable()
        sess.recorder.close()
        if stepcheck.armed_count() or telemetry.armed_count():
            raise AssertionError(f"{run}: armed after disable/close: {stepcheck.armed_count()} "
                                 f"checker(s), {telemetry.armed_count()} tracer(s)")
        del sess
    log(f"armed {label}: walls unarmed {[round(w, 3) for w in walls[False]]} s, armed "
        f"{[round(w, 3) for w in walls[True]]} s, overhead "
        f"{100 * (sum(walls[True]) / sum(walls[False]) - 1):+.1f}%")
    return page


def seeded_defects() -> None:
    """Three defects on the card, each found with the kinds the CPU tests
    find: the race demo's lost update (both sites), a barrier-arity lint
    raised before any thread starts, a DBarrier under the SPMD backend."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                        "torch_race_demo.py")
    spec = importlib.util.spec_from_file_location("torch_race_demo", path)
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    lines = open(path).read().splitlines()
    sites = {f"{path}:{i}" for i, text in enumerate(lines, 1)
             if "site A" in text or "site B" in text}
    found = demo.main([])                     # on the card; asserts its own result
    if {f.kind for f in found} != {"read-write", "write-write"} or not sites <= {
            s for f in found for s in f.sites}:
        raise AssertionError(f"race demo: {[f.as_dict() for f in found]}")
    if not all(f.sites and f.tids == (0, 1) for f in found):
        raise AssertionError("race demo: a finding without its sites or threads")
    log(f"seeded race on the card: {sorted(f.kind for f in found)}, sites "
        f"{sorted({s.rsplit('/', 1)[-1] for f in found for s in f.sites})}")

    sess = Session(backend=HostBackend(N_NODES, THREADS_PER_NODE), check=True)
    bar = sess.barrier(N_THREADS + 1)
    entered = []

    def arity(ctx):
        entered.append(threading.current_thread())
        bar.enter()

    try:
        sess.run(arity)
        raise AssertionError("barrier arity: the lint let the program run")
    except CheckError:
        pass
    kinds = [f.kind for f in sess.findings()]
    sess.checker.disable()
    if kinds != ["barrier-arity"] or len(entered) != N_THREADS or any(
            t is not threading.current_thread() for t in entered) or sess.thread_states():
        raise AssertionError(f"barrier arity: findings {kinds}, {len(entered)} dry runs, "
                             f"threads {sess.thread_states()}")
    log(f"seeded barrier-arity lint on the card: CheckError before any thread started, "
        f"findings {kinds}, {len(entered)} dry runs on the driver thread")

    sess = Session(backend=SpmdBackend(mesh=make_mesh((SPMD_POSITIONS,), ("data",))),
                   check=True)
    bar = sess.barrier()

    def host_sync(ctx, xs):
        bar.enter()
        return xs.sum()

    try:
        sess.run(host_sync, data=(torch.ones(8, 2, device="cuda"),))
        raise AssertionError("spmd host sync: the lint let the program run")
    except CheckError:
        pass
    found = sess.findings()
    sess.checker.disable()
    if [f.kind for f in found] != ["spmd-host-sync"] or found[0].tids != tuple(
            range(SPMD_POSITIONS)):
        raise AssertionError(f"spmd host sync: {[f.as_dict() for f in found]}")
    log(f"seeded DBarrier under SPMD on the card: findings ['spmd-host-sync'], "
        f"positions {found[0].tids}")
    if stepcheck.armed_count():
        raise AssertionError("a seeded defect's checker stayed armed")


def run_armed(keep: dict) -> dict:
    """Each app armed at phase 4's scale beside its unarmed run on the same
    data.  Launches per armed run, from the code: the accumulator's kernels
    as unarmed (the lint's dry run ends each accumulate at LintCtx, which
    launches nothing), plus what the dry run's one pass through each
    thread's proc launches itself: kmeans' assignment (D) once a thread;
    pagerank's set-up pass and its credit kernel once a thread (the dry run
    runs on the real slices on the card); logreg's and nmf's bodies launch
    no counted kernel."""
    counts: dict = {}
    edges = keep["edges"]           # phase ft runs pagerank on them again
    k = LJ_VERTICES // 4
    page = armed_pair(
        "pagerank auto", counts, lambda: HostBackend(N_NODES, THREADS_PER_NODE),
        lambda s: pagerank.fit(edges, LJ_VERTICES, iters=ITERS, mode="auto", session=s)[0],
        {"accumulate_blocked": ITERS, "fused_topk_scatter": 0, **pagerank_launches(N_THREADS)},
        lambda a, u: close(a, u, "pagerank auto armed vs unarmed"), watch=True,
        lint_extra=pagerank_launches(N_THREADS, rounds=1))
    lines = page.splitlines()
    log(f"armed pagerank auto: OpenMetrics page, {len(lines)} lines; head: "
        f"{json.dumps(lines[:12])}")
    if not page.endswith("# EOF\n") or "step_trace_record_only 1" not in lines:
        raise AssertionError("armed pagerank auto: the OpenMetrics page is malformed")
    trimmed = edges[: edges.shape[0] - edges.shape[0] % SPMD_POSITIONS]
    del edges
    armed_pair(
        "pagerank sparse unfused (trimmed edges)", counts,
        lambda: HostBackend(N_NODES, THREADS_PER_NODE, fused=False),
        lambda s: pagerank.fit(trimmed, LJ_VERTICES, iters=ITERS, mode="sparse", k=k,
                               session=s)[0],
        {"topk_compress_bitonic": ITERS * N_THREADS, "sparse_scatter_add": ITERS,
         "fused_topk_scatter": 0, **pagerank_launches(N_THREADS)},
        lambda a, u: close(a, u, "pagerank sparse unfused armed vs unarmed"),
        lint_extra=pagerank_launches(N_THREADS, rounds=1))
    del trimmed

    x, y = keep.pop("logreg")
    for fused, expected in ((True, {"fused_topk_scatter": ITERS, "sparse_scatter_add": 0}),
                            (False, {"topk_compress_argmax": ITERS * N_THREADS,
                                     "sparse_scatter_add": ITERS, "fused_topk_scatter": 0})):
        armed_pair(
            f"logreg sparse {'fused' if fused else 'unfused'}", counts,
            lambda: HostBackend(N_NODES, THREADS_PER_NODE, fused=fused),
            lambda s: logreg.fit(x, y, iters=ITERS, lr=LR_STEP, mode="sparse", k=LR_K,
                                 session=s)[0],
            expected, lambda a, u: close(a, u, "logreg armed vs unarmed"))
    # the SPMD backend: 4 positions as threads; the lint runs under the
    # mesh's even split, the race detector sees no position (as in repro)
    armed_pair(
        "logreg sparse spmd", counts,
        lambda: SpmdBackend(mesh=make_mesh((SPMD_POSITIONS,), ("data",))),
        lambda s: logreg.fit(x, y, iters=ITERS, lr=LR_STEP, mode="sparse", k=LR_K,
                             session=s)[0],
        {"topk_compress_argmax": ITERS * SPMD_POSITIONS, "sparse_scatter_add": ITERS,
         "fused_topk_scatter": 0},
        lambda a, u: close(a, u, "logreg spmd armed vs unarmed"))
    del x, y

    x, init_seed = keep.pop("kmeans")
    armed_pair(
        "kmeans kernel", counts, lambda: HostBackend(N_NODES, THREADS_PER_NODE),
        lambda s: kmeans.fit(x, COV_K, iters=ITERS, seed=init_seed, use_kernel=True,
                             session=s)[0],
        {"kmeans_assign": ITERS * N_THREADS},
        lambda a, u: np.testing.assert_allclose(a, u, rtol=1e-4, atol=1e-5,
                                                err_msg="kmeans armed vs unarmed"),
        lint_extra={"kmeans_assign": N_THREADS})    # the dry run's pass, a thread
    del x

    r = keep.pop("nmf")
    armed_pair(
        "nmf auto", counts, lambda: HostBackend(N_NODES, THREADS_PER_NODE),
        lambda s: nmf.fit(r, NMF_RANK, iters=ITERS, seed=NMF_INIT_SEED, mode="auto",
                          session=s)[1],
        {"accumulate_blocked": ITERS, "nmf_init": nmf_init.LAUNCHES_A_DRAW,
         "nmf_products": 2 * N_THREADS * ITERS},
        lambda a, u: np.testing.assert_allclose(a, u, rtol=1e-4,
                                                err_msg="nmf Q armed vs unarmed"),
        lint_extra={"nmf_products": 2 * N_THREADS})     # the dry run's round body, a thread
    del r
    seeded_defects()
    return counts


# ---------------------------------------------------------------------------
# Phase 6: ft — the tiered store under live rebalancing, pagerank through a
# tiered store, the FT drill at Covertype scale, checkpoints on the card
# ---------------------------------------------------------------------------

MIB = 1 << 20
TIER_SHARDS, TIER_THREADS = 4, 4
# (a): 2,048 entries of 1 MiB fp32 under the host tier, 256 under the disk
# tier; each shard's hot budget holds half of its share, so half goes cold
TIER_RUNS = {"host": 2048, "disk": 256}


class TimedTier:
    """A cold tier wrapped to time each demotion's copy off the card and to
    hold every payload to the bits it left with: a device-side checksum at
    ``put``, the same checksum of the host payload at ``get``."""

    def __init__(self, inner):
        self.inner, self.kind = inner, inner.kind
        self.put_s, self.put_bytes, self.sums = 0.0, 0, {}

    @staticmethod
    def _sum(t) -> int:
        words = t.contiguous().view(torch.int32) if t.element_size() == 4 else \
            t.contiguous().view(torch.int16).to(torch.int32)
        return int(words.sum(dtype=torch.int64))

    def put(self, name, value):
        self.sums[name] = self._sum(value)
        t0 = time.perf_counter()
        nb = self.inner.put(name, value)         # the blocking device -> host copy
        self.put_s += time.perf_counter() - t0
        self.put_bytes += nb
        return nb

    def get(self, name):
        payload = self.inner.get(name)
        if self._sum(payload) != self.sums[name]:
            raise AssertionError(f"cold tier: {name} came back with other bits")
        return payload

    def delete(self, name):
        self.sums.pop(name, None)
        self.inner.delete(name)

    def stats(self):
        return self.inner.stats()

    def close(self):
        self.inner.close()


def copy_rates(n: int = 256) -> tuple:
    """GB/s of blocking 1 MiB copies card -> pageable host memory and back,
    the two copies a demotion and a promotion make."""
    dev = torch.ones(MIB // 4, device="cuda")
    host = [dev.to("cpu") for _ in range(4)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        dev.to("cpu")
    d2h = n * MIB / (time.perf_counter() - t0) / 1e9
    t0 = time.perf_counter()
    for i in range(n):
        host[i % 4].to("cuda")
    torch.cuda.synchronize()
    h2d = n * MIB / (time.perf_counter() - t0) / 1e9
    return d2h, h2d


def tiered_rebalance(kind: str, n_entries: int, root=None) -> None:
    """(a): a 4-shard store on the card, half of it cold, under 4 writer
    threads (one writer a name; each op sets a name and reads it back, then
    reads the name half its list away, most often cold; each read held on
    the card to the writer's latest value) across add_shard(4) driven by
    migrate_step and then remove_shard(1)."""
    budget = n_entries * MIB // 2 // TIER_SHARDS
    tier = TimedTier(HostMemTier() if kind == "host" else DiskTier(root))
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    store = ShardedStore(shards=TIER_SHARDS, cold_tier=tier, cold_budget=budget)
    names = [f"blk{i:05d}" for i in range(n_entries)]
    t0 = time.perf_counter()
    for i, n in enumerate(names):
        store.def_global(n, torch.full((MIB // 4,), float(i), device="cuda"))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    ts = store.tier_stats()
    if ts["hot"]["bytes"] + ts["cold"]["bytes"] != n_entries * MIB or ts["cold_entries"] == 0:
        raise AssertionError(f"tier {kind}: after the fill {ts}")
    log(f"ft (a) {kind}: {n_entries} x 1 MiB fp32 on {TIER_SHARDS} shards, budget "
        f"{budget // MIB} MiB a shard: filled in {fill_s:.3f} s, hot {ts['hot']['entries']} "
        f"/ cold {ts['cold_entries']}, demotions {ts['demotions']}")
    old_ring = store._ring
    stop = threading.Event()
    errors, records, sets = [], [], {}

    def worker(t):
        mine = names[t::TIER_THREADS]
        latest = {n: float(names.index(n)) for n in mine}
        count = dict.fromkeys(mine, 0)
        k = 0
        try:
            while not stop.is_set():
                n = mine[k % len(mine)]
                far = mine[(k + len(mine) // 2) % len(mine)]
                k += 1
                t_op = time.perf_counter()
                latest[n] += 1.0
                store.set(n, torch.full((MIB // 4,), latest[n], device="cuda"))
                count[n] += 1
                for name in (n, far):
                    got = store.get(name)
                    if bool((got != latest[name]).any()):   # torn or stale, on the card
                        errors.append(f"{name}: read {got.unique()[:4].tolist()}, "
                                      f"wrote {latest[name]}")
                records.append((t_op, time.perf_counter()))
        except Exception as exc:  # surfaced below
            errors.append(f"worker {t}: {exc!r}")
        sets.update(count)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(TIER_THREADS)]
    for th in threads:
        th.start()
    windows = []
    try:
        time.sleep(0.5)
        totals0 = store.migration_totals()
        t0 = time.perf_counter()
        mig_add = store.add_shard(4, drain=False)
        steps = 0
        while store.migrate_step(8):
            steps += 1
        windows.append((t0, time.perf_counter()))
        added = store.migration_totals()
        new_ring = store._ring
        t0 = time.perf_counter()
        mig_rm = store.remove_shard(1)
        windows.append((t0, time.perf_counter()))
        time.sleep(0.5)
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=120)
    if any(th.is_alive() for th in threads) or errors:
        raise AssertionError(f"tier {kind}: {errors[:4]}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    # moved: the names whose owner the join changed under the port's ring (a
    # name a writer pulled before the planner listed its shard moved without
    # a record); the leave moves exactly shard 1's names
    changed = {n for n in names if old_ring.owner(n) != new_ring.owner(n)}
    if not set(mig_add.moved) <= changed or \
            added["entries_moved"] - totals0["entries_moved"] != len(changed):
        raise AssertionError(f"tier {kind}: add_shard moved {len(mig_add.moved)} recorded, "
                             f"{added['entries_moved'] - totals0['entries_moved']} in all, "
                             f"{len(changed)} changed owner")
    if set(mig_rm.moved) - {n for n in names if new_ring.owner(n) == 1}:
        raise AssertionError(f"tier {kind}: remove_shard(1) moved names it did not own")
    # epochs kept: each name's epoch is its writer's count of sets, exactly
    if any(store.epoch(n) != sets[n] for n in names):
        raise AssertionError(f"tier {kind}: an epoch differs from its writer's count of sets")
    ts = store.tier_stats()
    if ts["hot"]["bytes"] + ts["cold"]["bytes"] != n_entries * MIB:
        raise AssertionError(f"tier {kind}: hot + cold bytes {ts['hot']['bytes']} + "
                             f"{ts['cold']['bytes']} != {n_entries * MIB}")
    if store.shard_ids() != [0, 2, 3, 4] or sorted(store.names()) != names:
        raise AssertionError(f"tier {kind}: shards {store.shard_ids()}")
    # the hot budget of each shard ever on the ring, one entry over it while
    # a shard installs or promotes, and what each thread holds at once (the
    # value it sets, the two it read back and the comparison's mask)
    limit = 5 * (budget + MIB) + TIER_THREADS * 4 * MIB
    if peak > limit:
        raise AssertionError(f"tier {kind}: peak device memory {peak} > {limit}")
    # an op's time while a window was open against the others'
    during = [b - a for a, b in records if any(a < w1 and b > w0 for w0, w1 in windows)]
    outside = [b - a for a, b in records if not any(a < w1 and b > w0 for w0, w1 in windows)]
    d2h = tier.put_bytes / tier.put_s / 1e9 if tier.put_s else float("nan")
    # a single-threaded sweep over cold names: each read promotes one entry
    # (a copy to the card) and demotes another (a copy off it)
    cold = [n for n in names if n in store._shards[store.shard_of(n)].cold][:128]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in cold:
        store.get(n)
    torch.cuda.synchronize()
    swap = 2 * len(cold) * MIB / (time.perf_counter() - t0) / 1e9
    log(f"ft (a) {kind}: {len(records)} ops by {TIER_THREADS} writers, no stale or torn read; "
        f"add_shard(4) moved {added['entries_moved'] - totals0['entries_moved']} "
        f"({len(mig_add.moved)} recorded, {mig_add.pulled} pulled by ops, {steps} steps of "
        f"migrate_step(8)), window_s {mig_add.window_s:.4f}, bytes_moved {mig_add.bytes_moved}; "
        f"remove_shard(1) moved {len(mig_rm.moved)}, window_s {mig_rm.window_s:.4f}, "
        f"bytes_moved {mig_rm.bytes_moved}; demotions {ts['demotions']}, promotions "
        f"{ts['promotions']}, hot {ts['hot']['bytes'] / 2**30:.3f} GiB + cold "
        f"{ts['cold']['bytes'] / 2**30:.3f} GiB; demotions into the tier {d2h:.2f} GB/s "
        f"(the copy off the card and the tier's own work), a promote + demote sweep "
        f"{swap:.2f} GB/s both ways; ops (a set and two reads) while a window was open: "
        f"{len(during)}, median {statistics.median(during) if during else float('nan'):.4f} s, "
        f"worst {max(during, default=float('nan')):.4f} s; outside: {len(outside)}, median "
        f"{statistics.median(outside):.4f} s, worst {max(outside):.4f} s; peak device memory "
        f"{peak / 2**30:.3f} GiB (limit {limit / 2**30:.3f})")
    tier.close()
    del store


def tiered_pagerank(edges, untiered, counts: dict):
    """(b): pagerank AUTO on phase 4's edges through a store whose hot
    budget is below the rank vector, so each round demotes and promotes;
    a Watchdog polls the run."""
    r_u, wire_u, wall_u = untiered
    budget = LJ_VERTICES * 4 * 5 // 6        # below the rank vector (19.4 MB)
    tier = TimedTier(HostMemTier())
    sess = Session(n_nodes=N_NODES, threads_per_node=THREADS_PER_NODE,
                   cold_tier=tier, cold_budget=budget)
    wd = sess.watchdog(interval_s=0.05)
    wd.start()
    try:
        (r_t, s_t), launched = run_app("pagerank auto tiered", counts, lambda: pagerank.fit(
            edges, LJ_VERTICES, iters=ITERS, mode="auto", session=sess))
    finally:
        wd.stop()
    expect_launches("pagerank auto tiered", launched, {"accumulate_blocked": ITERS,
                                                       "fused_topk_scatter": 0,
                                                       **pagerank_launches(N_THREADS)})
    if wd.errors or wd.anomalies:
        raise AssertionError(f"pagerank tiered: watchdog {wd.errors[:2]} "
                             f"{[a.kind for a in wd.anomalies]}")
    if s_t.wire_traffic() != wire_u:
        raise AssertionError(f"pagerank tiered: wire {s_t.wire_traffic()} != {wire_u}")
    ts = sess.store.tier_stats()
    # each round's Set of credits, then of ranks, finds its entry cold: it
    # takes the tier slot back without loading (the value is overwritten)
    # and demotes the other vector; only a read of a cold entry loads
    if ts["demotions"] < 2 * ITERS or ts["cold_hits"] < 2 * ITERS:
        raise AssertionError(f"pagerank tiered: not two demotions a round: {ts}")
    close(r_t, r_u, "pagerank auto tiered vs untiered")
    same = bool(np.array_equal(r_t, r_u))
    log(f"ft (b) pagerank auto tiered (budget {budget // MIB} MiB, rank vector "
        f"{LJ_VERTICES * 4 / 1e6:.1f} MB): wall {WALLS['pagerank auto tiered']:.3f} s vs "
        f"untiered {wall_u:.3f} s, wire {s_t.wire_traffic()} (== untiered), bit-equal to the "
        f"untiered run: {same}, max rel diff "
        f"{float(np.max(np.abs(r_t - r_u) / np.maximum(np.abs(r_u), 1e-30))):.3e}; demotions "
        f"{ts['demotions']} ({tier.put_bytes / 1e9:.2f} GB to the host at "
        f"{tier.put_bytes / max(tier.put_s, 1e-9) / 1e9:.2f} GB/s), promotions that load "
        f"{ts['promotions']}, cold hits {ts['cold_hits']}, each load back with its bits; "
        f"watchdog {wd.polls} polls, no anomaly")
    ranks = sess.ref("ranks").get()
    tier.close()
    return ranks


def ft_drill(x, init_seed: int, counts: dict) -> tuple:
    """(c): kmeans on 4 nodes x 1 thread over 4 shards, node 2 declared dead
    by the heartbeat monitor, recovered single and multi; the recovered
    session's kmeans against a fresh session of the survivors' shape."""
    centers = None
    for mode, tpn in (("single", 2), ("multi", 1)):
        sess = Session(n_nodes=4, threads_per_node=1, shards=4)
        for i in range(64):                 # the drill's own state, on every shard
            sess.store.def_global(f"drill/state{i}", torch.full((256,), float(i), device="cuda"))
        _, launched = run_app(f"ft kmeans before the failure ({mode})", counts, lambda: kmeans.fit(
            x, COV_K, iters=1, seed=init_seed, use_kernel=True, session=sess))
        expect_launches(f"ft kmeans before ({mode})", launched, {"kmeans_assign": 4})
        failures = []
        mon = HeartbeatMonitor(list(range(4)), timeout=10.0, on_failure=failures.append)
        for node in range(4):
            mon.beat(node, metrics_payload(sess))
        mon.declare_dead(2)
        if failures != [[2]] or mon.last_payload(2)["wire_traffic"] != sess.wire_traffic():
            raise AssertionError(f"ft drill: failures {failures}")
        names = sess.names()
        owners = {n: sess.store.shard_of(n) for n in names}
        epochs = {n: sess.store.epoch(n) for n in names}
        t0 = time.perf_counter()
        plan, recovered = session_recovery(sess, failures[0], mode=mode, threads_per_node=tpn)
        recover_s = time.perf_counter() - t0
        mig = plan.migration
        if mig is None or set(mig.moved) != {n for n in names if owners[n] == 2} or any(
                src != 2 for src, _ in mig.moved.values()) or any(
                recovered.store.epoch(n) != epochs[n] for n in names):
            raise AssertionError(f"ft drill ({mode}): migration {mig}")
        (c_r, _), launched = run_app(f"ft kmeans recovered ({mode})", counts, lambda: kmeans.fit(
            x, COV_K, iters=ITERS, seed=init_seed, use_kernel=True, session=recovered))
        expect_launches(f"ft kmeans recovered ({mode})", launched,
                        {"kmeans_assign": ITERS * 3 * tpn})
        (c_f, _), _ = run_app(f"ft kmeans fresh 3 x {tpn}", counts, lambda: kmeans.fit(
            x, COV_K, iters=ITERS, seed=init_seed, use_kernel=True,
            session=Session(backend=HostBackend(3, tpn))))
        np.testing.assert_allclose(c_r, c_f, rtol=1e-4, atol=1e-5,
                                   err_msg=f"ft kmeans recovered ({mode}) vs fresh")
        log(f"ft (c) {mode}-node recovery in {recover_s:.4f} s: reassign {plan.reassignment}, "
            f"ring moved {len(mig.moved)}/{mig.total_names} names off shard 2 (epochs kept, "
            f"window_s {mig.window_s:.4f}), recovered 3 x {tpn} kmeans "
            f"{WALLS[f'ft kmeans recovered ({mode})']:.3f} s vs fresh "
            f"{WALLS[f'ft kmeans fresh 3 x {tpn}']:.3f} s, centers max abs diff "
            f"{np.abs(c_r - c_f).max():.3e}")
        centers = recovered.ref("centers").get()
    return centers


def ft_checkpoint(centers, ranks, sample, root: str) -> None:
    """(d): kmeans' centers, pagerank's ranks, a bf16 leaf and a sample of
    the points saved from the card (once through AsyncCheckpointer), then
    restore_checkpoint and elastic_restore onto a 4-position mesh, each
    bit-equal on the card."""
    tree = {"kmeans": {"centers": centers, "sample": sample},
            "pagerank": {"ranks": ranks, "ranks_bf16": ranks.to(torch.bfloat16)}}
    t0 = time.perf_counter()
    save_checkpoint(root, 1, tree)
    save_s = time.perf_counter() - t0
    saver = AsyncCheckpointer(root)
    t0 = time.perf_counter()
    saver.save(2, tree, extra={"iters": ITERS})
    handed_s = time.perf_counter() - t0
    saver.wait()
    specs = {"kmeans": {"centers": P(), "sample": P("data", None)},
             "pagerank": {"ranks": P(), "ranks_bf16": P()}}
    mesh = make_mesh((SPMD_POSITIONS,), ("data",))
    for step in (1, 2):
        got, extra, _ = restore_checkpoint(root, tree, step=step)
        again, _, _ = elastic_restore(root, tree, mesh, specs, step=step)
        for restored in (got, again):
            for group, leaves in tree.items():
                for name, want in leaves.items():
                    t = restored[group][name]
                    if t.device.type != "cuda" or t.dtype != want.dtype or not torch.equal(t, want):
                        raise AssertionError(f"ft checkpoint step {step}: {group}.{name}")
    nbytes = sum(t.numel() * t.element_size() for g in tree.values() for t in g.values())
    log(f"ft (d) checkpoint: {nbytes / 1e6:.1f} MB in 4 leaves (one bf16), saved in "
        f"{save_s:.3f} s, AsyncCheckpointer handed back in {handed_s:.3f} s; "
        f"restore_checkpoint and elastic_restore onto a {SPMD_POSITIONS}-position mesh "
        f"bit-equal on the card; extra {extra}")


def run_ft(keep: dict) -> dict:
    """Phase 6 (ft): every run of it on the card, any failure raises."""
    counts: dict = {}
    d2h, h2d = copy_rates()
    log(f"ft: blocking 1 MiB copies, card -> pageable host {d2h:.2f} GB/s, host -> card "
        f"{h2d:.2f} GB/s")
    tiered_rebalance("host", TIER_RUNS["host"])
    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as spill:
        tiered_rebalance("disk", TIER_RUNS["disk"], root=spill)
    ranks = tiered_pagerank(keep.pop("edges"), keep.pop("pagerank_auto"), counts)
    x, _, _ = kmeans_dataset(COV_ROWS, COV_FEATURES, COV_K, seed=SEED)
    centers = ft_drill(x, keep.pop("kmeans_init_seed"), counts)
    sample = torch.from_numpy(x[:4096]).cuda()
    del x
    with tempfile.TemporaryDirectory(dir=build_dir) as root:
        ft_checkpoint(centers, ranks, sample, root)
    return counts


# ---------------------------------------------------------------------------
# Phase 7: the LM serving path at full width
# ---------------------------------------------------------------------------


def logit_gap(label: str, full, stepped) -> tuple:
    """Print and return max |dlogit| of a forward against the decode steps,
    max |logit| of the forward, and whether the argmax agrees everywhere."""
    delta = float((full - stepped).abs().max())
    scale = float(full.abs().max())
    same = bool(torch.equal(full.argmax(-1), stepped.argmax(-1)))
    log(f"lm {label} vs {LM_CONSISTENCY} decode steps: max |dlogit| {delta:.3e}, "
        f"max |logit| {scale:.3e}, ratio {delta / scale:.3e} (limit 1e-3), "
        f"argmax equal at every position: {same}")
    return delta, scale, same


def teacher_forced(model, cache, tokens) -> tuple:
    """The decode steps over ``tokens`` (B, T) from ``cache``: their logits
    (B, T, V), and tokens/s in each DECODE_BLOCK-step block, each timed
    between two synchronisations (the steps double as a decode-rate
    window)."""
    rates, steps = [], []
    with torch.no_grad():
        for pos in range(tokens.shape[1]):
            if pos % DECODE_BLOCK == 0:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            step, cache = model.decode_step(cache, tokens[:, pos:pos + 1], pos)
            steps.append(step[:, 0])
            if (pos + 1) % DECODE_BLOCK == 0:
                torch.cuda.synchronize()
                rates.append(tokens.shape[0] * DECODE_BLOCK / (time.perf_counter() - t0))
    return torch.stack(steps, dim=1), rates


def lm_inputs(cfg, t: int) -> dict:
    """A prefill batch of ``cfg``'s family, B x ``t``, drawn on the card from
    SEED (an InitStream: the same values on any device): random tokens, and
    the vlm's random vision embeddings (the vision frontend is a stub:
    ``vision_tokens`` x ``vision_dim``)."""
    inputs = InitStream(SEED)
    batch = {"tokens": inputs.draw((LM_BATCH, t), kind="integers", high=cfg.vocab,
                                   dtype=torch.int32, device="cuda")}
    if cfg.family == "vlm":
        batch["vision_embeds"] = inputs.draw((LM_BATCH, cfg.vision_tokens, cfg.vision_dim),
                                             device="cuda")
    return batch


def prompt_of(batch: dict) -> dict:
    """``batch`` with its tokens cut to the first LM_CONSISTENCY."""
    return dict(batch, tokens=batch["tokens"][:, :LM_CONSISTENCY])


def flips_with_margins(label: str, ref, other) -> int:
    """Print each position where ``other``'s argmax is not ``ref``'s, with
    ``ref``'s top-2 margin there (a flip at a margin within the gap is a near
    tie of random weights, not a wrong token); returns the count."""
    ref, other = ref.float(), other.float()
    top = ref.topk(2, dim=-1).values
    margin = top[..., 0] - top[..., 1]
    where = (ref.argmax(-1) != other.argmax(-1)).nonzero().tolist()
    shown = [f"(b {b}, t {t}): margin {float(margin[b, t]):.3e}" for b, t in where[:16]]
    log(f"{label}: argmax differs at {len(where)} of {ref.shape[0] * ref.shape[1]} positions"
        f"{'; ' + ', '.join(shown) if shown else ''}; smallest top-2 margin anywhere "
        f"{float(margin.min()):.3e}")
    return len(where)


def near_ties_only(arch: str, full, stepped, delta: float) -> bool:
    """Whether each position where the forward's and the decode's argmax
    differ is a near tie: the forward's top two logits within 2 max |dlogit|
    (``delta``) of each other there, each printed with its margin."""
    flips_with_margins(f"lm {arch} forward against decode", full, stepped)
    top = full.float().topk(2, dim=-1).values
    margin = top[..., 0] - top[..., 1]
    flipped = full.argmax(-1) != stepped.argmax(-1)
    ties = bool((margin[flipped] <= 2 * delta).all())
    log(f"lm {arch}: {int(flipped.sum())} argmax flips, each at a near tie (top-2 margin "
        f"within 2 max |dlogit| = {2 * delta:.3e}): {ties}")
    return ties


def leaf_sums(model, dtypes: dict = None) -> dict:
    """Each parameter's dtype (``dtypes[name]``, else its own) and the
    integer sum of its values' bits in that dtype: equal for equal values in
    any order of summation.  In pieces of 2^26 values (deepseek's expert
    stacks hold 3.76 G values)."""
    out = {}
    for n, p in model.named_parameters():
        dt = (dtypes or {}).get(n, p.dtype)
        bits = torch.int16 if dt == BF16 else torch.int32
        out[n] = (dt, sum(int(q.to(dt).view(bits).sum(dtype=torch.int64))
                          for q in p.detach().reshape(-1).split(1 << 26)))
    return out


def bf16_vs_f32(arch: str, cfg, sums: dict, moe, stepped, tokens, limit, rms_limit) -> None:
    """The bf16 decode's logits ``stepped`` against the fp32 decode of the
    same bf16-representable weights: the fp32 build from SEED rounded to
    bf16 in place, in pieces, where the bf16 build held bf16 (the router
    stays fp32), each leaf's bits checked equal to the bf16 build's by their
    sum (``sums``, ``leaf_sums``); the moe family decodes at the bf16 run's
    ``moe`` config.  The rms of the error over the fp32 logits' rms within
    ``rms_limit`` and max |error| over max |logit| within ``limit`` (each
    printed only where ``None``; the max printed only for the moe family:
    a routing flip between the two is a discrete change)."""
    f32 = build_model(cfg.replace(dtype="float32"), generator=SEED)
    if moe is not None:
        f32.moe_cfg = moe
    with torch.no_grad():
        for n, p in f32.named_parameters():
            if sums[n][0] == BF16:
                for q in p.view(-1).split(1 << 26):
                    q.copy_(q.to(BF16))
    if leaf_sums(f32, {n: dt for n, (dt, _) in sums.items()}) != sums:
        raise AssertionError(f"{arch}: the fp32 build rounded to bf16 is not the bf16 build")
    (ref, rates), _ = run_app(f"lm {arch} fp32 decode of the bf16 weights {LM_CONSISTENCY} "
                              "steps", {}, lambda: teacher_forced(f32, f32.init_cache(
                                  LM_BATCH, LM_CONSISTENCY), tokens))
    del f32
    err = stepped.float() - ref
    rms = float(err.square().mean().sqrt() / ref.square().mean().sqrt())
    worst = float(err.abs().max() / ref.abs().max())
    log(f"lm {arch} bf16 decode vs the fp32 decode of its weights over {LM_CONSISTENCY} "
        f"teacher-forced steps: error rms / logit rms {rms:.4e} (limit {rms_limit}), max "
        f"|error| / max |logit| {worst:.4e} (limit {None if moe is not None else limit}; None: "
        f"printed only); the fp32 decode {[round(r, 1) for r in rates]} tokens/s")
    flips_with_margins(f"lm {arch} bf16 against fp32 decode", ref, stepped)
    if (rms_limit is not None and not rms <= rms_limit) or (
            moe is None and limit is not None and not worst <= limit):
        raise AssertionError(f"{arch}: the bf16 decode is off the fp32 decode of its weights")
    del ref, err
    torch.cuda.empty_cache()


def run_lm_bf16(arch: str, counts: dict, *, n_layers: int = None, limit=BF16_DECODE_GAP,
                rms_limit=None, kernels: dict = None, serving: bool = True) -> None:
    """``repro``'s serving policy (bf16 parameters and compute,
    ``repro/launch/dryrun.py:125``) on ``arch`` at BF16_RUNS' cut (or
    ``n_layers``): built from SEED (the draw timed); where the run says so a
    4 x 2048 prefill; the kernels' forward on 256 tokens against 256 decode
    steps (four 64-step blocks timed, the peak memory of the decode
    printed), max |dlogit| within ``limit`` of max |logit| and the error's
    rms within ``rms_limit`` of the logits' (``None``: printed only), each
    argmax flip printed with its top-2 margin; the vlm's cross caches
    filled as run_vlm fills them; the moe family's forward at
    MOE_FORWARD_CAPACITY, its decode at E / k; where fp32 fits on the card
    (for a BF16_DEEP arch, at its cut), the decode against the fp32 decode
    of the same weights (``bf16_vs_f32``); then, with ``serving``,
    ``serve(smoke=False)`` at the same cut in bf16."""
    overrides, run_kernels, prefill, f32_check = BF16_RUNS[arch]
    f32_check = f32_check and (n_layers is not None or arch not in BF16_DEEP)
    overrides = dict(overrides, **({"n_layers": n_layers} if n_layers else {}))
    kernels = kernels or run_kernels
    cfg = get_arch(arch).replace(dtype="bfloat16", **overrides)
    t0 = time.perf_counter()
    model = build_model(cfg, generator=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"lm {arch} bf16: {n_params} parameters "
        f"({sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB), "
        f"{cfg.n_layers} of {get_arch(arch).n_layers} layers, built in "
        f"{time.perf_counter() - t0:.2f} s")
    step = make_prefill_step(model)
    batch = lm_inputs(cfg, LM_PREFILL)
    prompt = prompt_of(batch)
    step(prompt)                                         # warm-up, not counted
    if prefill and n_layers is None:
        label = f"lm {arch} bf16 prefill {LM_BATCH}x{LM_PREFILL}"
        logits, launched = run_app(label, counts, lambda: step(batch))
        log(f"lm {arch} bf16 prefill: {LM_BATCH * LM_PREFILL / WALLS[label]:.1f} tokens/s by "
            f"run_app's wall; peak device memory {PEAKS[label]:.3f} GiB")
        expect_launches(f"{arch} bf16 prefill", launched, kernels)
        if logits.shape != (LM_BATCH, LM_PREFILL, cfg.vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{arch} bf16 prefill: logits not finite or of the wrong shape")
        del logits
    moe = getattr(model, "moe_cfg", None)
    if moe is not None:
        model.moe_cfg = moe._replace(capacity_factor=MOE_FORWARD_CAPACITY[arch])
    full, launched = run_app(f"lm {arch} bf16 forward {LM_BATCH}x{LM_CONSISTENCY}, "
                             f"{cfg.n_layers} layers", counts, lambda: step(prompt))
    expect_launches(f"{arch} bf16 forward", launched, kernels)
    if moe is not None:
        model.moe_cfg = moe._replace(capacity_factor=moe.n_experts / moe.top_k)
    cache = model.init_cache(LM_BATCH, LM_CONSISTENCY)
    if cfg.family == "vlm":
        fill_cross_caches(model, cache, batch["vision_embeds"])
    label = f"lm {arch} bf16 decode {LM_CONSISTENCY} steps, {cfg.n_layers} layers"
    (stepped, rates), _ = run_app(label, counts,
                                  lambda: teacher_forced(model, cache, prompt["tokens"]))
    log(f"lm {arch} bf16 decode, {cfg.n_layers} layers, batch {LM_BATCH}, tokens/s per "
        f"{DECODE_BLOCK}-step block: {[round(r, 1) for r in rates]} (median "
        f"{statistics.median(rates):.1f}); peak device memory {PEAKS[label]:.3f} GiB")
    if stepped.dtype != BF16 or not bool(torch.isfinite(stepped.float()).all()) or not bool(
            torch.isfinite(full.float()).all()):
        raise AssertionError(f"{arch} bf16: logits {stepped.dtype} or not finite")
    delta = float((full.float() - stepped.float()).abs().max())
    scale = float(full.float().abs().max())
    rms = float((full.float() - stepped.float()).square().mean().sqrt()
                / full.float().square().mean().sqrt())
    log(f"lm {arch} bf16 forward vs {LM_CONSISTENCY} decode steps, {cfg.n_layers} layers: max "
        f"|dlogit| {delta:.3e}, max |logit| {scale:.3e}, ratio {delta / scale:.3e} (limit "
        f"{limit}), rms ratio {rms:.3e} (limit {rms_limit}; None: printed only)")
    flips_with_margins(f"lm {arch} bf16 forward against decode", full, stepped)
    if (limit is not None and not delta <= limit * scale) or (
            rms_limit is not None and not rms <= rms_limit):
        raise AssertionError(f"{arch}: the bf16 forward and decode disagree")
    sums = leaf_sums(model) if f32_check else None
    moe = getattr(model, "moe_cfg", None)
    del full, cache, step, batch, model
    gc.collect()
    torch.cuda.empty_cache()
    if f32_check:
        bf16_vs_f32(arch, cfg, sums, moe, stepped, prompt["tokens"], limit,
                    BF16_VS_F32_RMS if limit is not None else rms_limit)
    del stepped, prompt
    torch.cuda.empty_cache()
    if not serving:
        return

    # the serving loop itself in bf16: serve() takes repro's signature (no
    # dtype), so the arch's config carries it, at the same cut
    with arch_cut(arch, dtype="bfloat16", **overrides):
        toks, _ = run_app(f"lm {arch} bf16 serve", counts,
                          lambda: serve(arch, smoke=False, batch=LM_BATCH, prompt_len=32,
                                        gen=32, seed=SEED))
    if toks.shape != (LM_BATCH, 32) or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"{arch} bf16 serve: tokens {toks.shape} out of range")
    torch.cuda.empty_cache()


def moe_inputs(model) -> tuple:
    """A forward hook on each MoE layer of ``model`` that keeps the layer's
    input and config of each call (references only: nothing is computed or
    read back while the model runs); returns (the kept calls, the hooks)."""
    calls: list = []
    hooks = [m.register_forward_hook(lambda mod, args, out: calls.append((mod, *args)))
             for m in model.modules() if isinstance(m, MoE)]
    return calls, hooks


def no_expert_over_capacity(label: str, calls: list) -> None:
    """Every MoE call in ``calls`` routed no expert more slots than its C."""
    worst = []
    for mod, x, cfg in calls:
        loads, c = expert_loads(mod, x, cfg)
        worst.append((int(loads.max()), c))
    if not worst or any(load > c for load, c in worst):
        raise AssertionError(f"{label}: an expert's load passed its capacity: {worst}")
    log(f"lm {label}: {len(worst)} MoE calls, largest expert load / C "
        f"{max(load for load, _ in worst)} / {worst[0][1]}: no slot dropped")


def routing_differences(forward_calls: list, decode_calls: list) -> list:
    """``(row, step, layer, margin)`` for each (token, MoE layer) whose
    routed experts differ between the forward's calls (one a layer, B x T
    tokens) and the decode steps' (one a layer a step, B tokens): a near
    tie that the two paths' rounding breaks apart, ``margin`` being the
    least gap between neighbours among the forward router's k + 1 largest
    probabilities at that token."""
    n_moe = len(forward_calls)
    want = [routed_experts(*c).reshape(LM_BATCH, LM_CONSISTENCY, -1) for c in forward_calls]
    differ = []
    for j, call in enumerate(decode_calls):
        step, layer = divmod(j, n_moe)
        for row in (routed_experts(*call) != want[layer][:, step]).any(-1).nonzero().flatten():
            mod, x, cfg = forward_calls[layer]
            with torch.no_grad():
                top = torch.softmax(x[int(row), step].float() @ mod["router"], -1).topk(
                    cfg.top_k + 1).values
            differ.append((int(row), step, layer, float((top[:-1] - top[1:]).min())))
    return differ


def run_lm(shapes: dict) -> dict:
    # the app phase's sessions hold device tensors in reference cycles: free
    # them, so the peak memory read here is the models'
    gc.collect()
    torch.cuda.empty_cache()
    counts: dict = {}
    for arch, (overrides, kernels) in LM_MODELS.items():
        cfg = get_arch(arch).replace(**overrides)
        t0 = time.perf_counter()
        model = build_model(cfg, generator=SEED)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        log(f"lm {arch}: {n_params} parameters ({n_params * 4 / 1e9:.2f} GB fp32), "
            f"{cfg.n_layers} of {get_arch(arch).n_layers} layers, built in "
            f"{time.perf_counter() - t0:.2f} s")
        prefill = make_prefill_step(model)
        tokens = lm_inputs(cfg, LM_PREFILL)["tokens"]
        prefill({"tokens": tokens[:, :LM_CONSISTENCY]})      # warm-up, not counted

        # (a) prefill at B x T
        label = f"lm {arch} prefill {LM_BATCH}x{LM_PREFILL}"
        logits, launched = run_app(label, counts, lambda: prefill({"tokens": tokens}))
        e_share, e_shape = "", f"flash_attention@{E_SHAPE_OF.get(arch, arch)}"
        if e_shape in shapes:
            e_ms = shapes[e_shape]["ms"]
            e_share = (f"; E's share {cfg.n_layers} x {e_ms:.4f} ms / "
                       f"{WALLS[label] * 1e3:.1f} ms = "
                       f"{cfg.n_layers * e_ms / (WALLS[label] * 1e3):.1%}")
        log(f"lm {arch} prefill: {LM_BATCH * LM_PREFILL / WALLS[label]:.1f} tokens/s by "
            f"run_app's wall; peak device memory {PEAKS[label]:.3f} GiB, launches "
            f"{json.dumps({k: v for k, v in launched.items() if v})}{e_share}")
        expect_launches(f"{arch} prefill", launched, kernels)
        if logits.shape != (LM_BATCH, LM_PREFILL, cfg.vocab) or not bool(
                torch.isfinite(logits).all()):
            raise AssertionError(f"{arch} prefill: logits {tuple(logits.shape)} not finite "
                                 "or of the wrong shape")
        del logits

        # (b) forward vs decode steps on one prompt: the kernel inside the
        # model, with its causal mask or chunk carry, against the cache path
        prompt = tokens[:, :LM_CONSISTENCY]
        moe = getattr(model, "moe_cfg", None)
        if moe is not None:
            model.moe_cfg = moe._replace(capacity_factor=MOE_FORWARD_CAPACITY[arch])
            forward_calls, hooks = moe_inputs(model)
        full, launched = run_app(f"lm {arch} forward {LM_BATCH}x{LM_CONSISTENCY}", counts,
                                 lambda: prefill({"tokens": prompt}))
        expect_launches(f"{arch} forward", launched, kernels)
        if moe is not None:
            for h in hooks:
                h.remove()
            no_expert_over_capacity(f"{arch} forward at capacity "
                                    f"{MOE_FORWARD_CAPACITY[arch]}", forward_calls)
            decode_calls, hooks = moe_inputs(model)
            model.moe_cfg = moe._replace(capacity_factor=moe.n_experts / moe.top_k)
            c_decode = capacity(model.moe_cfg._replace(data_groups=1), LM_BATCH)
            if c_decode < LM_BATCH:
                raise AssertionError(f"{arch}: decode capacity {c_decode} < batch {LM_BATCH}")
            log(f"lm {arch} decode: capacity factor E/k = {moe.n_experts / moe.top_k:.4f}, "
                f"C {c_decode} at batch {LM_BATCH}: no slot can drop")
        cache = model.init_cache(LM_BATCH, LM_CONSISTENCY)
        stepped, rates = teacher_forced(model, cache, prompt)
        before_flip = None
        if moe is not None:
            for h in hooks:
                h.remove()
            flips = routing_differences(forward_calls, decode_calls)
            log(f"lm {arch}: routed experts differ between the forward and the decode steps "
                f"at {len(flips)} of {len(decode_calls) * LM_BATCH} (token, MoE layer) pairs"
                + "".join(f"; row {b} step {t} layer {layer}: the router's least top-"
                          f"{moe.top_k + 1} gap {m:.3e}" for b, t, layer, m in flips[:8])
                + f" (each must be a near tie, within {ROUTING_TIE})")
            if any(m > ROUTING_TIE for *_, m in flips):
                raise AssertionError(f"{arch}: a routing difference that is no near tie")
            # a flipped route changes that token's output, which later
            # positions of its row attend to: the gate holds the positions
            # before each row's first flip
            before_flip = torch.ones(LM_BATCH, LM_CONSISTENCY, dtype=torch.bool,
                                     device=full.device)
            for b, t, _, _ in flips:
                before_flip[b, t:] = False
            del forward_calls, decode_calls
        log(f"lm {arch} decode, batch {LM_BATCH}, tokens/s per {DECODE_BLOCK}-step block: "
            f"{[round(r, 1) for r in rates]} (median {statistics.median(rates):.1f}); peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        delta, scale, same = logit_gap(f"{arch} prefill", full, stepped)
        if before_flip is not None and not bool(before_flip.all()):
            if not bool(before_flip.any()):
                raise AssertionError(f"{arch}: every row's routes differ from its first step")
            delta, scale, same = logit_gap(
                f"{arch} prefill, the {int(before_flip.sum())} positions before each row's "
                "first routing difference", full[before_flip], stepped[before_flip])
        if not same and arch in NEAR_TIE_ARCHS:
            same = near_ties_only(arch, full, stepped, delta)
        if not delta <= 1e-3 * scale or not same:
            raise AssertionError(f"{arch}: prefill and decode disagree")
        if "ssd_scan" in kernels:
            # the same check on the plain versions (the chunked algorithm,
            # and blocked attention where the model has attention), with the
            # same weights and prompt: a gap like the kernels' is the
            # algorithms'
            model.ssm = model.ssm._replace(ssd_impl="chunked")
            plain_impls = "chunked"
            if "flash_attention" in kernels:
                model.gqa = model.gqa._replace(attention_impl="blocked")
                plain_impls = "chunked SSD + blocked attention"
        elif moe is not None:
            # the kernel's forward against blocked attention's, at the
            # forward's capacity, on the same weights and prompt
            model.moe_cfg = moe._replace(capacity_factor=MOE_FORWARD_CAPACITY[arch])
            if cfg.attn_kind == "mla":
                model.mla = model.mla._replace(attention_impl="blocked")
            else:
                model.gqa = model.gqa._replace(attention_impl="blocked")
            plain_impls = "blocked attention"
        if "ssd_scan" in kernels or moe is not None:
            plain, launched = run_app(f"lm {arch} plain forward {LM_BATCH}x{LM_CONSISTENCY}",
                                      counts, lambda: prefill({"tokens": prompt}))
            expect_launches(f"{arch} plain forward", launched,
                            {name: 0 for name in kernels})
            logit_gap(f"{arch} {plain_impls} (plain) forward", plain, stepped)
            log(f"lm {arch} kernel vs {plain_impls} forward: max |dlogit| "
                f"{float((full - plain).abs().max()):.3e}")
            del plain
        del model, prefill, full, stepped, cache
        torch.cuda.empty_cache()

        # (c) the serving loop (prefill by decode + greedy): at full width,
        # but the moe family's under smoke_config (its whole configs do not
        # fit one card; its decode rate at full width is (b)'s); qwen2-72b's
        # in bf16 only (run_lm_bf16)
        if arch in BF16_SERVE_ONLY:
            continue
        smoke = cfg.family == "moe"
        toks, _ = run_app(f"lm {arch} serve{' (smoke_config)' if smoke else ''}", counts,
                          lambda: serve(arch, smoke=smoke, batch=LM_BATCH, prompt_len=32,
                                        gen=32, seed=SEED))
        vocab = smoke_config(cfg).vocab if smoke else cfg.vocab
        if toks.shape != (LM_BATCH, 32) or toks.min() < 0 or toks.max() >= vocab:
            raise AssertionError(f"{arch} serve: tokens {toks.shape} out of range")
        torch.cuda.empty_cache()
    for arch in BF16_RUNS:
        if arch == VLM:
            run_vlm(counts)
        if arch in BF16_DEEP:
            # whole: printed; gated by the rms at the depth cut
            n_layers, kernels = BF16_DEEP[arch]
            run_lm_bf16(arch, counts, limit=None, rms_limit=None)
            run_lm_bf16(arch, counts, n_layers=n_layers, limit=None,
                        rms_limit=BF16_VS_F32_RMS, kernels=kernels, serving=False)
        else:
            run_lm_bf16(arch, counts)
    run_hubert(counts, shapes)
    run_int8_decode(counts)
    run_long_500k(counts)
    return counts


# the vlm and audio families and the int8 KV cache (phase 7).
# llama-3.2-vision-90b is cut in whole superblocks, each its 4 self blocks and
# the cross block closing it, every width as published: whole it holds
# 87,729,709,056 parameters (351 GB in fp32), so 3 of its 20 superblocks in
# fp32 (14,999,085,056, 55.9 GiB) and 7 in bf16 (32,112,173,056, 59.8 GiB);
# hubert-xlarge runs whole (945,574,400)
VLM, AUDIO = "llama-3.2-vision-90b", "hubert-xlarge"
VLM_PERIOD = get_arch(VLM).cross_attn_period
VLM_SUPER_F32 = 3
INT8_ARCH = "qwen3-1.7b"
INT8_SMOKE_ARCH, INT8_SMOKE_STEPS, INT8_SMOKE_GAP = "qwen2-72b", 12, 0.15  # test_archs_smoke.py:82


@contextlib.contextmanager
def arch_cut(arch: str, **overrides):
    """``configs.ARCHS[arch]`` replaced by its config with ``overrides`` (a
    depth cut) while the block runs: ``serve`` and ``train`` take an arch by
    name."""
    whole = configs.ARCHS[arch]
    configs.ARCHS[arch] = whole.replace(**overrides)
    try:
        yield configs.ARCHS[arch]
    finally:
        configs.ARCHS[arch] = whole


def fill_cross_caches(model, cache: dict, vision_embeds) -> None:
    """Each cross block's decode cache filled with its vision K/V as
    ``cross_attend`` computes them (``kv_embeds @ wk``, ``@ wv``, k-norm
    where the config sets it).  ``repro``'s vlm decode never fills them (its
    ``serve`` takes no image), so this check fills them itself."""
    with torch.no_grad():
        vis = model._vision_of({"vision_embeds": vision_embeds})
        for sblk, c in zip(model.segments["seg0"], cache["seg0"]["cross"]):
            p = sblk["cross"]["attn"]
            k = torch.einsum("bsd,dhk->bshk", vis, p["wk"])
            c.k.copy_(rms_norm(k, p["k_norm"]) if model.cfg.qk_norm else k)
            c.v.copy_(torch.einsum("bsd,dhk->bshk", vis, p["wv"]))


def run_vlm(counts: dict) -> None:
    """llama-3.2-vision-90b in fp32 at VLM_SUPER_F32 of its 20 superblocks,
    on E: (a) a 4 x 2048 prefill over 1,601 random vision embeddings of
    width 7,680, E once a block (the self blocks causal at G 8, the cross
    blocks non-causal over the vision keys); (b) its forward on the first
    256 tokens against 256 decode steps over cross caches filled with the
    vision K/V; (c) ``serve(smoke=False)`` at the same cut, on the zero
    cross caches ``init_cache`` makes, as ``repro`` serves it."""
    whole = get_arch(VLM)
    cfg = whole.replace(attention_impl="pallas", n_layers=VLM_SUPER_F32 * VLM_PERIOD)
    t0 = time.perf_counter()
    model = build_model(cfg, generator=SEED)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"lm {VLM}: {n_params} parameters ({n_params * 4 / 2**30:.2f} GiB fp32), "
        f"{VLM_SUPER_F32} of {whole.n_layers // VLM_PERIOD} superblocks ({cfg.n_layers} of "
        f"{whole.n_layers} layers), built in {time.perf_counter() - t0:.2f} s")
    prefill = make_prefill_step(model)
    batch = lm_inputs(cfg, LM_PREFILL)
    prompt = prompt_of(batch)
    prefill(prompt)                                      # warm-up, not counted
    kernels = {"flash_attention": cfg.n_layers}          # 4 self + 1 cross a superblock

    label = f"lm {VLM} prefill {LM_BATCH}x{LM_PREFILL}"
    logits, launched = run_app(label, counts, lambda: prefill(batch))
    log(f"lm {VLM} prefill: {LM_BATCH * LM_PREFILL / WALLS[label]:.1f} tokens/s by run_app's "
        f"wall; peak device memory {PEAKS[label]:.3f} GiB")
    expect_launches(f"{VLM} prefill", launched, kernels)
    if logits.shape != (LM_BATCH, LM_PREFILL, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{VLM} prefill: logits {tuple(logits.shape)} not finite or of "
                             "the wrong shape")
    del logits

    full, launched = run_app(f"lm {VLM} forward {LM_BATCH}x{LM_CONSISTENCY}", counts,
                             lambda: prefill(prompt))
    expect_launches(f"{VLM} forward", launched, kernels)
    cache = model.init_cache(LM_BATCH, LM_CONSISTENCY)
    fill_cross_caches(model, cache, batch["vision_embeds"])
    stepped, rates = teacher_forced(model, cache, prompt["tokens"])
    log(f"lm {VLM} decode, batch {LM_BATCH}, tokens/s per {DECODE_BLOCK}-step block: "
        f"{[round(r, 1) for r in rates]} (median {statistics.median(rates):.1f}); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    delta, scale, same = logit_gap(f"{VLM} prefill (cross caches filled)", full, stepped)
    if not delta <= 1e-3 * scale:
        raise AssertionError(f"{VLM}: prefill and decode disagree")
    if not same:
        # within max |dlogit| of each other, the two can pick different
        # tokens only where the forward's top two lie within 2 max |dlogit|
        near = full.topk(2, dim=-1).values
        ties = int(((near[..., 0] - near[..., 1]) <= 2 * delta).sum())
        flips = int((full.argmax(-1) != stepped.argmax(-1)).sum())
        log(f"lm {VLM}: argmax differs at {flips} of {full.shape[0] * full.shape[1]} "
            f"positions, each a near tie: {ties} positions have the forward's top two "
            f"logits within 2 max |dlogit| = {2 * delta:.3e} (random weights over "
            f"{cfg.vocab} classes, max |logit| {scale:.3f})")
    del model, prefill, full, stepped, cache, batch, prompt
    torch.cuda.empty_cache()

    with arch_cut(VLM, n_layers=cfg.n_layers):
        toks, _ = run_app(f"lm {VLM} serve ({VLM_SUPER_F32} superblocks, zero cross caches)",
                          counts, lambda: serve(VLM, smoke=False, batch=LM_BATCH, prompt_len=32,
                                                gen=32, seed=SEED))
    if toks.shape != (LM_BATCH, 32) or toks.min() < 0 or toks.max() >= cfg.vocab:
        raise AssertionError(f"{VLM} serve: tokens {toks.shape} out of range")
    torch.cuda.empty_cache()


def run_hubert(counts: dict, shapes: dict) -> None:
    """hubert-xlarge whole in fp32, on E: a 4 x 2048-frame encode (E once a
    layer, non-causal MHA at head dim 80), its tokens/s, peak memory and
    E's share (phase 3's time at this shape x 48 over the wall); then the
    kernel's logits on the first 256 frames against blocked attention's on
    the same weights, within 1e-3 of max |logit|."""
    cfg = get_arch(AUDIO).replace(attention_impl="pallas")
    model = build_model(cfg, generator=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"lm {AUDIO}: {n_params} parameters ({n_params * 4 / 1e9:.2f} GB fp32), whole")
    prefill = make_prefill_step(model)
    frames = InitStream(SEED).draw((LM_BATCH, LM_PREFILL, cfg.frame_dim), device="cuda")
    prefill({"frames": frames[:, :LM_CONSISTENCY]})      # warm-up, not counted
    label = f"lm {AUDIO} encode {LM_BATCH}x{LM_PREFILL}"
    logits, launched = run_app(label, counts, lambda: prefill({"frames": frames}))
    rate = LM_BATCH * LM_PREFILL / WALLS[label]
    expect_launches(f"{AUDIO} encode", launched, {"flash_attention": cfg.n_layers})
    if logits.shape != (LM_BATCH, LM_PREFILL, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{AUDIO} encode: logits not finite or of the wrong shape")
    e_ms = shapes[f"flash_attention@{AUDIO}"]["ms"]
    log(f"lm {AUDIO} encode: {rate:.1f} frames/s by run_app's wall; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; E's share {cfg.n_layers} x "
        f"{e_ms:.4f} ms / {WALLS[label] * 1e3:.1f} ms = "
        f"{cfg.n_layers * e_ms / (WALLS[label] * 1e3):.1%}")
    del logits
    head = {"frames": frames[:, :LM_CONSISTENCY]}
    kernel = prefill(head)
    model.gqa = model.gqa._replace(attention_impl="blocked")
    plain, launched = run_app(f"lm {AUDIO} blocked encode {LM_BATCH}x{LM_CONSISTENCY}", counts,
                              lambda: prefill(head))
    expect_launches(f"{AUDIO} blocked encode", launched, {"flash_attention": 0})
    delta, scale = float((kernel - plain).abs().max()), float(plain.abs().max())
    log(f"lm {AUDIO} kernel vs blocked encode: max |dlogit| {delta:.3e}, max |logit| "
        f"{scale:.3e}, ratio {delta / scale:.3e} (limit 1e-3)")
    if not delta <= 1e-3 * scale:
        raise AssertionError(f"{AUDIO}: the kernel's encode and blocked attention's disagree")
    del model, prefill, frames, kernel, plain
    torch.cuda.empty_cache()


def run_int8_decode(counts: dict) -> None:
    """kv_cache_dtype="int8": (f) qwen3-1.7b at full width, 256 teacher-forced
    steps recording the K/V rows each step quantizes, the cache's codes and
    scales bit-equal to ``_quantize_i8`` on the CPU over those rows; then
    the unquantized cache's decode and the int8 cache's, each timed in four
    64-step blocks, and their logit gap printed (not gated at full width);
    last, at smoke size, the int8 decode within 0.15 of the unquantized one
    at every step (``repro``'s own limit)."""
    cfg = get_arch(INT8_ARCH).replace(kv_cache_dtype="int8")
    model = build_model(cfg, generator=SEED)
    tokens = lm_inputs(cfg, LM_CONSISTENCY)["tokens"]
    rows, quantize = [], attention._quantize_i8

    def recording(x):
        rows.append(x.detach().clone())
        return quantize(x)

    cache = model.init_cache(LM_BATCH, LM_CONSISTENCY)
    attention._quantize_i8 = recording
    try:
        teacher_forced(model, cache, tokens)
    finally:
        attention._quantize_i8 = quantize
    layers = cache["seg0"]
    kh, hd = model.gqa.n_kv_heads, model.gqa.head_dim
    x = torch.stack(rows).reshape(LM_CONSISTENCY, len(layers), 2, LM_BATCH, kh, hd).cpu()
    del rows
    codes, scales = quantize(x)                          # on the CPU
    for i, c in enumerate(layers):
        for j, (q, sc) in enumerate(((c.k_q, c.k_s), (c.v_q, c.v_s))):
            q, sc = q.cpu().transpose(0, 1), sc.cpu().transpose(0, 1)
            if not (torch.equal(q, codes[:, i, j]) and torch.equal(sc, scales[:, i, j])):
                raise AssertionError(
                    f"int8 cache, layer {i} {'kv'[j]}: {int((q != codes[:, i, j]).sum())} "
                    f"codes and {int((sc != scales[:, i, j]).sum())} scales differ from the "
                    "CPU quantizer's")
    log(f"int8 {INT8_ARCH}: the cache's codes and bf16 scales over {LM_CONSISTENCY} steps x "
        f"{len(layers)} layers x K, V ({x.numel()} values) bit-equal to _quantize_i8 on the CPU")
    del x, codes, scales, cache, layers

    dtype = torch.float32
    plain_cache = {"seg0": [attention.init_gqa_cache(model.gqa, LM_BATCH, LM_CONSISTENCY, dtype,
                                                     device="cuda")
                            for _ in range(cfg.n_layers)]}
    (plain, plain_rates), launched = run_app(
        f"int8 {INT8_ARCH} unquantized decode {LM_CONSISTENCY} steps", counts,
        lambda: teacher_forced(model, plain_cache, tokens))
    (quant, quant_rates), _ = run_app(
        f"int8 {INT8_ARCH} int8 decode {LM_CONSISTENCY} steps", counts,
        lambda: teacher_forced(model, model.init_cache(LM_BATCH, LM_CONSISTENCY), tokens))
    delta, scale = float((quant - plain).abs().max()), float(plain.abs().max())
    agree = float((quant.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"int8 {INT8_ARCH} decode, batch {LM_BATCH}, tokens/s per {DECODE_BLOCK}-step block: "
        f"unquantized {[round(r, 1) for r in plain_rates]}, int8 "
        f"{[round(r, 1) for r in quant_rates]}; int8 against unquantized over "
        f"{LM_CONSISTENCY} teacher-forced steps: max |dlogit| {delta:.3e} (max |logit| "
        f"{scale:.3e}), argmax equal at {agree:.2%} of positions")
    del model, plain, quant, plain_cache
    torch.cuda.empty_cache()

    scfg = smoke_config(get_arch(INT8_SMOKE_ARCH))
    m = build_model(scfg, generator=SEED)
    mq = build_model(scfg.replace(kv_cache_dtype="int8"), generator=SEED)   # the same weights
    toks = InitStream(SEED).draw((2, INT8_SMOKE_STEPS), kind="integers", high=scfg.vocab,
                                 dtype=torch.int32, device="cuda")
    full, _ = teacher_forced(m, m.init_cache(2, INT8_SMOKE_STEPS), toks)
    quant, _ = teacher_forced(mq, mq.init_cache(2, INT8_SMOKE_STEPS), toks)
    worst = float((full - quant).abs().amax(dim=(0, 2)).max())
    log(f"int8 {INT8_SMOKE_ARCH} smoke_config: max |dlogit| against the unquantized decode "
        f"over {INT8_SMOKE_STEPS} steps {worst:.4f} (limit {INT8_SMOKE_GAP} at every step)")
    if not worst < INT8_SMOKE_GAP:
        raise AssertionError(f"int8 {INT8_SMOKE_ARCH}: the int8 decode is {worst} off")


# the long_500k cell (configs/base.py's SHAPES): one decode step of one
# sequence against a 524,288-deep cache, for the ssm and hybrid archs in
# bf16 (cell_runnable: only they run it); zamba2's 9 shared-attention KV
# caches hold 524,288 x 32 heads x 80 x 2 x 2 B = 5.37 GB each
LONG_ARCHS = ("mamba2-2.7b", "zamba2-2.7b")


def run_long_500k(counts: dict) -> None:
    """build_cell(cfg in bf16, SHAPES["long_500k"], make_host_mesh(1, 1)) on
    the card from SEED, for each of LONG_ARCHS: a warm-up step at the
    second-last slot, then the cell's step at the last, timed (wall and
    peak memory printed); finite logits.  mamba2, whose state does not grow
    with the context: its states filled from InitStream(SEED + 1) before the
    warm-up, and the step from the same state on the CPU (the cell's
    weights moved there) within BF16_DECODE_GAP of max |logit|.  zamba2:
    each of its 9 KV caches written at the step's slot, zeros before it,
    and its first K and V leaf equal everywhere else to a host copy taken
    before the step."""
    shape = SHAPES["long_500k"]
    for arch in LONG_ARCHS:
        cfg = get_arch(arch).replace(dtype="bfloat16")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cell = build_cell(cfg, shape, make_host_mesh(1, 1, device="cuda"), generator=SEED)
        torch.cuda.synchronize()
        params, batch = cell.args
        cache, pos = batch["cache"], shape.seq_len - 1
        cache_gb = sum(t.numel() * t.element_size() for t in tree_leaves(cache)) / 1e9
        log(f"long_500k {arch}: {cell.param_count} parameters "
            f"({cell.param_bytes / 1e9:.2f} GB bf16) and a {shape.seq_len}-deep cache of "
            f"{cache_gb:.2f} GB built in {time.perf_counter() - t0:.2f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        if arch == "mamba2-2.7b":
            states = InitStream(SEED + 1)
            with torch.no_grad():
                for leaf in tree_leaves(cache):
                    leaf.copy_(states.draw(leaf.shape, dtype=leaf.dtype, device="cuda"))
        cell.step(params, dict(batch, pos=torch.tensor(pos - 1)))      # warm-up, not timed
        if arch == "mamba2-2.7b":
            before = [leaf.to("cpu", copy=True) for leaf in tree_leaves(cache)]
        else:
            kv = cache["attn"]
            if any(bool(c.k[:, pos].any()) or bool(c.v[:, pos].any()) for c in kv):
                raise AssertionError("long_500k zamba2: a cache slot written before its step")
            before = (kv[0].k.to("cpu", copy=True), kv[0].v.to("cpu", copy=True))
        label = f"long_500k {arch} decode step at position {pos}"
        (logits, _), _ = run_app(label, counts, lambda: cell.step(params, batch))
        if logits.shape != (1, 1, cfg.vocab) or not bool(torch.isfinite(logits.float()).all()):
            raise AssertionError(f"long_500k {arch}: logits {tuple(logits.shape)} not finite "
                                 "or of the wrong shape")
        log(f"long_500k {arch}: the step's wall {WALLS[label] * 1e3:.2f} ms, peak device "
            f"memory {PEAKS[label]:.3f} GiB")
        if arch == "zamba2-2.7b":
            if not all(bool(c.k[:, pos].any()) and bool(c.v[:, pos].any()) for c in kv):
                raise AssertionError("long_500k zamba2: a KV cache not written at the step")
            for name, old, new in (("k", before[0], kv[0].k), ("v", before[1], kv[0].v)):
                new = new.cpu()
                if not (torch.equal(new[:, :pos], old[:, :pos])
                        and bool(new[:, pos].ne(old[:, pos]).any())):
                    raise AssertionError(f"long_500k zamba2: the step wrote {name} outside "
                                         f"slot {pos}, or not there")
            log(f"long_500k zamba2: each of the {len(kv)} KV caches written at slot {pos}, "
                f"the first K and V ({tuple(kv[0].k.shape)}, bf16) equal elsewhere to the "
                "copy before the step")
        else:
            model = cell.model.to("cpu")
            model.device = torch.device("cpu")
            host = tree_unflatten(cache, before)
            want, _ = model.decode_step(host, batch["tokens"].cpu(), pos)
            delta = float((logits.float().cpu() - want.float()).abs().max())
            scale = float(want.float().abs().max())
            log(f"long_500k mamba2: the card's step against the CPU's from the same state and "
                f"weights: max |dlogit| {delta:.3e}, max |logit| {scale:.3e}, ratio "
                f"{delta / scale:.3e} (limit {BF16_DECODE_GAP})")
            if not delta <= BF16_DECODE_GAP * scale:
                raise AssertionError("long_500k mamba2: the card's step is off the CPU's")
            del model, host, want
        del cell, params, batch, cache, logits, before
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The weights' draw: every model's leaves and inputs from a seed
# ---------------------------------------------------------------------------

DRAWS: dict = {}        # device type -> [values drawn, seconds], over the whole run
OLD_DRAW: dict = {}     # values and seconds of the pre-seed draw on the card (phase 8)


def count_draws() -> None:
    """Wrap ``common.draw`` (every weight, token and input the script draws
    from a seed) to add each call's values and seconds, between two
    synchronisations, to DRAWS."""
    inner = common.draw

    def timed(key, shape, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(key, shape, **kw)
        torch.cuda.synchronize()
        if out.device.type != "meta":
            d = DRAWS.setdefault(out.device.type, [0, 0.0])
            d[0] += out.numel()
            d[1] += time.perf_counter() - t0
        return out

    common.draw = timed


def weight_draw_times() -> None:
    """qwen3-1.7b's and zamba2-2.7b's weights at full width in fp32, as
    train() builds them, drawn from SEED on the card (the build timed
    between synchronisations); then the same leaves drawn the way the port
    drew them before its stream was made device-independent
    (``nn.init.trunc_normal_`` on the card's own generator, times the
    fan-in scale; ``normal_`` times 0.02 for the embeddings), for the new
    draw's cost."""
    for arch in ("qwen3-1.7b", "zamba2-2.7b"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = build_model(get_arch(arch), generator=SEED)
        torch.cuda.synchronize()
        new = time.perf_counter() - t0
        drawn = [p for p in model.parameters() if p.dim() >= 2]
        n = sum(p.numel() for p in drawn)
        gen = torch.Generator("cuda").manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for p in drawn:
                t = torch.empty(p.shape, device="cuda")
                if p.shape[0] == model.cfg.vocab:
                    t.normal_(0.0, 1.0, generator=gen)
                else:
                    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
                p.copy_((t * 0.02).to(p.dtype))
                del t
        torch.cuda.synchronize()
        old = time.perf_counter() - t0
        OLD_DRAW[arch] = (n, old)
        log(f"draw {arch}: {n} weights drawn from the seed in {new:.3f} s ({n / new / 1e9:.2f} "
            f"G values/s, the build included); the pre-seed draw of the same leaves on the "
            f"card's generator {old:.3f} s ({n / old / 1e9:.2f} G values/s)")
        del model, drawn
        torch.cuda.empty_cache()


def draw_summary() -> None:
    """The run's draws, and what the pre-seed draw would have taken for the
    card's share at qwen3's measured rate."""
    n_old, s_old = OLD_DRAW.get("qwen3-1.7b", (0, 0.0))
    for dev, (n, secs) in sorted(DRAWS.items()):
        extra = ""
        if dev == "cuda" and s_old:
            extra = (f"; the pre-seed draw at phase 8's rate {n * s_old / n_old:.2f} s, so the "
                     f"seed's draw costs {secs - n * s_old / n_old:.2f} s more")
        log(f"draws on {dev}: {n} values in {secs:.2f} s{extra}")


# ---------------------------------------------------------------------------
# Phase 8: training — the trainer at full width, the card against the CPU,
# ZeRO-1 over mesh positions and error-feedback compression
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 8, 128      # repro's trainer defaults: 1,024 tokens
SMOKE_STEPS, SMOKE_RESUME_AT = 10, 6
MAMBA_TRAIN_LAYERS, MAMBA_TRAIN_STEPS = 16, 4        # of mamba2-2.7b's 64 layers
ZAMBA_TRAIN_STEPS = 4                                # zamba2-2.7b at its full config
# moonshot-v1-16b-a3b at full width cut to 1 dense + 2 MoE layers (1.93 B
# parameters, ~54 GB at AdamW's update); deepseek-v3-671b's smoke_config
# (MLA + MoE + MTP) on the card against the CPU
MOONSHOT_TRAIN_LAYERS, MOONSHOT_TRAIN_STEPS = 3, 4
ZERO_LAYERS, ZERO_STEPS = 2, 3                       # qwen3-1.7b at full width, 2 layers
HUBERT_TRAIN_STEPS = 4                               # hubert-xlarge at its full config
EF_DIVISORS = ((32, "topk_compress_argmax"), (4, "topk_compress_bitonic"))   # k = n / d
TRAIN_LR = 3e-4                                      # repro's trainer default
CARD_VS_CPU_RTOL, RESUME_RTOL = 1e-4, 1e-5
ZERO_TOL = dict(rtol=1e-5, atol=1e-7)
ZERO_BF16_TOL = dict(rtol=2e-2, atol=2e-2)           # tests/test_spmd.py:58
STEP_LINE = re.compile(r"\[train\] step\s+(\d+) loss\s+(\S+) \(([\d.]+)s this step")


class _Tee:
    """Write to two streams: a run's output stays visible while it is
    captured for parsing."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for s in self.streams:
            s.write(text)

    def flush(self):
        for s in self.streams:
            s.flush()


def train_loop(model, opt, steps: int, device, metrics: list = None):
    """``steps`` steps of ``make_train_step`` on ``LMDataPipeline``'s batches,
    as ``train`` runs them; returns the losses and each step's seconds (a
    step ends when its loss reaches the host).  Each step's metrics (ce,
    aux, ...) are appended to ``metrics`` where one is given."""
    step_fn = make_train_step(model, opt)
    params = model.param_tree()
    state = opt.init(params)
    pipe = LMDataPipeline(TRAIN_BATCH, TRAIN_SEQ, model.cfg.vocab, seed=SEED, device=device)
    losses, secs = [], []
    try:
        for _ in range(steps):
            t0 = time.perf_counter()
            step, batch = pipe.next()
            batch = batch_for(model.cfg, None, batch)
            params, state, loss, m = step_fn(params, state, batch, step)
            losses.append(float(loss))
            secs.append(time.perf_counter() - t0)
            if metrics is not None:
                metrics.append({k: float(v) for k, v in m.items()})
    finally:
        pipe.close()
    return losses, secs


def check_losses(label: str, losses, n: int) -> None:
    if len(losses) != n or not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: losses {losses} are not {n} finite values")


def max_rel(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def train_full(arch: str, steps: int, counts: dict) -> list:
    """train() on ``arch`` at its full config, ``steps`` steps of TRAIN_BATCH
    x TRAIN_SEQ: finite losses and no flash_attention or ssd_scan launch
    (blocked attention and chunked SSD, as repro trains); each step's
    seconds from the trainer's own log line, the median tokens/s of steps
    2 on (1 on when there are fewer than 4).  Returns the losses."""
    out = io.StringIO()

    def run():
        with contextlib.redirect_stdout(_Tee(sys.stdout, out)):
            return train(arch, smoke=False, steps=steps, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                         log_every=1, seed=SEED)

    losses, launched = run_app(f"train {arch} {steps} x {TRAIN_BATCH}x{TRAIN_SEQ}", counts, run)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_losses(f"train {arch}", losses, steps)
    expect_launches(f"train {arch} (blocked attention and chunked SSD, as repro trains)",
                    launched, {"flash_attention": 0, "ssd_scan": 0})
    secs = {int(m.group(1)): float(m.group(3)) for m in STEP_LINE.finditer(out.getvalue())}
    if sorted(secs) != list(range(steps)):
        raise AssertionError(f"train {arch}: log lines for steps {sorted(secs)}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    first = 2 if steps >= 4 else 1
    rates = [tokens / secs[s] for s in range(first, steps)]
    log(f"train {arch}: {tokens} tokens a step; step seconds "
        f"{[secs[s] for s in range(steps)]}; median tokens/s of steps "
        f"{first}-{steps - 1} {statistics.median(rates):.1f}; peak device memory "
        f"{peak:.3f} GiB; losses {losses}")
    return losses


def train_full_qwen3(counts: dict) -> None:
    """(a): train() on qwen3-1.7b at its full config (its model kept by
    wrapping the trainer's ``build_model``): the trained weights fit the
    first step's batch better than the initial weights did (that step's
    logged loss).  The tokens are uniform over 151,936 classes, so a fresh
    batch's loss moves by less than the noise between batches over 8 steps,
    and the last loss need not be below the first (12.294 -> 12.319 from
    the device-independent seed's weights)."""
    built = []
    trainer = importlib.import_module("repro_torch.launch.train")

    def keep(cfg, **kw):
        built.append(build_model(cfg, **kw))
        return built[-1]

    trainer.build_model = keep
    try:
        losses = train_full("qwen3-1.7b", TRAIN_STEPS, counts)
    finally:
        trainer.build_model = build_model
    model = built.pop()
    pipe = LMDataPipeline(TRAIN_BATCH, TRAIN_SEQ, model.cfg.vocab, seed=SEED, device="cuda")
    try:
        step, raw = pipe.next()
    finally:
        pipe.close()
    with torch.no_grad():
        after = float(model.loss_fn(batch_for(model.cfg, None, raw))[0])
    log(f"train qwen3-1.7b: step {step}'s batch, loss {losses[0]:.4f} at the initial "
        f"weights, {after:.4f} with the trained weights")
    if not after < losses[0]:
        raise AssertionError(f"train qwen3-1.7b: training did not lower the first batch's loss "
                             f"({losses[0]} -> {after})")
    del model


def train_full_zamba2(counts: dict) -> None:
    """(f): train() on zamba2-2.7b at its full config (2,422,670,240
    parameters, fp32 AdamW: ~63 GiB at the update by qwen3's 7.02 x the
    parameters), its shared attention block's gradient summed over its 9
    applications."""
    cfg = get_arch("zamba2-2.7b")
    log(f"train zamba2-2.7b: full config, {cfg.n_layers} mamba layers in "
        f"{cfg.n_layers // cfg.hybrid_period} superblocks, no depth cut")
    train_full("zamba2-2.7b", ZAMBA_TRAIN_STEPS, counts)


def train_full_hubert(counts: dict) -> None:
    """(i): train() on hubert-xlarge at its full config (945,574,400
    parameters, fp32 AdamW), HUBERT_TRAIN_STEPS steps of 8 x 128 frames
    (the trainer's frames and labels, by ``batch_for``), blocked attention
    as ``repro`` trains."""
    train_full(AUDIO, HUBERT_TRAIN_STEPS, counts)


def pallas_backward_refused(arch: str, impl: dict) -> None:
    """A model asked for the flash kernel or the SSD scan kernel cannot be
    trained; its backward raises repro's NotImplementedError instead of
    leaving the kernel's inputs out of the graph."""
    cfg = smoke_config(get_arch(arch)).replace(**impl)
    model = build_model(cfg, generator=SEED)
    model.requires_grad_(True)
    batch = batch_for(cfg, None, shard_batch(lm_batch(0, 2, 64, cfg.vocab)))
    loss, _ = model.loss_fn(batch)
    try:
        loss.backward()
    except NotImplementedError as e:
        log(f"train {arch} smoke, {impl}: backward raised NotImplementedError: {e}")
    else:
        raise AssertionError(f"{arch}: a backward through {impl} did not raise")


def card_vs_cpu(arch: str, counts: dict, **kw) -> None:
    """``train(arch, smoke=True)`` from SEED on the CPU and on the card,
    SMOKE_STEPS steps of the trainer's batches: each device draws the seed's
    weights itself (ROADMAP Queue 3 fault 4), so the losses agree within
    CARD_VS_CPU_RTOL.  ``kw`` goes to ``train`` (a mesh's axes)."""
    losses = []
    for dev in ("cpu", "cuda"):
        run, _ = run_app(f"train() {arch} smoke {SMOKE_STEPS} steps on {dev}", counts,
                         lambda: train(arch, smoke=True, steps=SMOKE_STEPS, batch=TRAIN_BATCH,
                                       seq=TRAIN_SEQ, seed=SEED, log_every=SMOKE_STEPS,
                                       device=dev, **kw))
        check_losses(f"train() {arch} on {dev}", run, SMOKE_STEPS)
        losses.append(run)
    cpu_losses, card_losses = losses
    rel = max_rel(card_losses, cpu_losses)
    log(f"train {arch} smoke, card against CPU: max relative loss difference {rel:.3e} "
        f"(limit {CARD_VS_CPU_RTOL}); card losses {card_losses}")
    if not rel <= CARD_VS_CPU_RTOL:
        raise AssertionError(f"train {arch} smoke: the card's losses are {rel:.3e} off the "
                             "CPU's")


def train_smoke_checks(counts: dict) -> None:
    """(b): train() on smoke_config on the card against the CPU from the
    seed alone; then train() stopped at a checkpoint and resumed, against
    its uninterrupted run."""
    card_vs_cpu("qwen3-1.7b", counts)

    kw = dict(smoke=True, batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED, log_every=SMOKE_STEPS)
    full = train("qwen3-1.7b", steps=SMOKE_STEPS, **kw)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as root:
        train("qwen3-1.7b", steps=SMOKE_RESUME_AT, ckpt_dir=root,
              ckpt_every=SMOKE_RESUME_AT - 1, total_steps=SMOKE_STEPS, **kw)
        resumed = train("qwen3-1.7b", steps=SMOKE_STEPS, ckpt_dir=root, **kw)
    want = full[SMOKE_RESUME_AT:]
    if len(resumed) != len(want):
        raise AssertionError(f"train smoke resume ran {len(resumed)} steps, not {len(want)}")
    rel = max_rel(resumed, want)
    log(f"train smoke resume at step {SMOKE_RESUME_AT}: max relative loss difference "
        f"{rel:.3e} (limit {RESUME_RTOL}), bit-equal: {resumed == want}")
    if not rel <= RESUME_RTOL:
        raise AssertionError(f"train smoke resume: {resumed} against {want}")


def train_mamba_cut(counts: dict) -> None:
    """(c): mamba2-2.7b at full width, its depth cut to MAMBA_TRAIN_LAYERS:
    its 64 layers at fp32 with AdamW need ~45 GB of state before
    activations."""
    cfg = get_arch("mamba2-2.7b").replace(n_layers=MAMBA_TRAIN_LAYERS)
    model = build_model(cfg, generator=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train mamba2-2.7b: depth cut to {MAMBA_TRAIN_LAYERS} of 64 layers, {n_params} "
        f"parameters ({n_params * 16 / 1e9:.2f} GB of fp32 params, grads and two moments)")
    opt = adamw(lr=warmup_cosine(TRAIN_LR, 1, MAMBA_TRAIN_STEPS))
    (losses, secs), launched = run_app(
        f"train mamba2-2.7b {MAMBA_TRAIN_LAYERS} layers {MAMBA_TRAIN_STEPS} x "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}", counts,
        lambda: train_loop(model, opt, MAMBA_TRAIN_STEPS, "cuda"))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_losses("train mamba2-2.7b", losses, MAMBA_TRAIN_STEPS)
    expect_launches("train mamba2-2.7b (chunked SSD, as repro trains)", launched,
                    {"ssd_scan": 0})
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"train mamba2-2.7b: step seconds {secs}; tokens/s of steps 1-"
        f"{MAMBA_TRAIN_STEPS - 1} {[round(tokens / s, 1) for s in secs[1:]]}; peak device "
        f"memory {peak:.3f} GiB; losses {losses}")


def train_moonshot_cut(counts: dict) -> None:
    """(g): moonshot-v1-16b-a3b at full width, its depth cut to 1 dense + 2
    MoE layers: finite losses and balance losses (aux), no flash_attention
    launch (blocked attention, as repro trains)."""
    cfg = get_arch("moonshot-v1-16b-a3b").replace(n_layers=MOONSHOT_TRAIN_LAYERS)
    model = build_model(cfg, generator=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"train moonshot-v1-16b-a3b: depth cut to {MOONSHOT_TRAIN_LAYERS} of 48 layers "
        f"({cfg.first_dense_layers} dense, {MOONSHOT_TRAIN_LAYERS - cfg.first_dense_layers} "
        f"MoE), {n_params} parameters ({n_params * 16 / 1e9:.2f} GB of fp32 params, grads "
        "and two moments)")
    opt = adamw(lr=warmup_cosine(TRAIN_LR, 1, MOONSHOT_TRAIN_STEPS))
    metrics: list = []
    (losses, secs), launched = run_app(
        f"train moonshot-v1-16b-a3b {MOONSHOT_TRAIN_LAYERS} layers {MOONSHOT_TRAIN_STEPS} x "
        f"{TRAIN_BATCH}x{TRAIN_SEQ}", counts,
        lambda: train_loop(model, opt, MOONSHOT_TRAIN_STEPS, "cuda", metrics))
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_losses("train moonshot-v1-16b-a3b", losses, MOONSHOT_TRAIN_STEPS)
    aux = [m["aux"] for m in metrics]
    check_losses("train moonshot-v1-16b-a3b balance losses", aux, MOONSHOT_TRAIN_STEPS)
    expect_launches("train moonshot-v1-16b-a3b (blocked attention, as repro trains)",
                    launched, {"flash_attention": 0})
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"train moonshot-v1-16b-a3b: step seconds {secs}; tokens/s of steps 1-"
        f"{MOONSHOT_TRAIN_STEPS - 1} {[round(tokens / s, 1) for s in secs[1:]]}; peak device "
        f"memory {peak:.3f} GiB; losses {losses}; aux {aux}")
    del model, opt


def zero1_run(counts: dict):
    """(d): ZeRO-1 over SPMD_POSITIONS mesh positions as threads on the card.
    Each position differentiates the shared model on its quarter of the
    batch (shard_map over P("data")) and steps through zero1_update; the
    gathered fp32 master is held against a replicated AdamW on the
    position-order mean gradient, the bf16 params to tests/test_spmd.py's
    2e-2.  The model's weights follow the master from step to step.
    Returns the positions' last gradients, packed, for (e)."""
    cfg = get_arch("qwen3-1.7b").replace(n_layers=ZERO_LAYERS)
    model = build_model(cfg, generator=SEED)
    model.requires_grad_(True)
    params = model.param_tree()
    n_params = sum(p.numel() for p in params.values())
    log(f"zero1: qwen3-1.7b cut to {ZERO_LAYERS} layers, {n_params} parameters "
        f"({n_params * 4 / 1e9:.2f} GB fp32), {SPMD_POSITIONS} positions")
    spec = pack_spec(params)
    mesh = make_mesh((SPMD_POSITIONS,), ("data",), device="cuda")
    opt = adamw(lr=warmup_cosine(TRAIN_LR, 1, ZERO_STEPS))
    states = [None] * SPMD_POSITIONS
    grads = [None] * SPMD_POSITIONS
    bf16 = {}

    def position(tokens, labels):
        i = axis_index("data")
        loss, _ = model.loss_fn({"tokens": tokens, "labels": labels})
        g = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        if states[i] is None:
            states[i] = zero1_init(params, opt, axis_size("data"), i, spec)
        new_params, states[i] = zero1_update(g, states[i], opt, "data", spec)
        if i == 0:
            bf16.update(new_params)
        grads[i] = g
        return zero1_gather_params(states[i], "data", spec, dtype=torch.float32)

    def steps() -> float:
        ref = {k: p.detach().clone() for k, p in params.items()}
        ref_state = opt.init(ref)
        pipe = LMDataPipeline(TRAIN_BATCH, TRAIN_SEQ, cfg.vocab, mesh=mesh, seed=SEED,
                              prefetch=False)
        worst = 0.0
        for s in range(ZERO_STEPS):
            _, batch = pipe.next()
            master = shard_map(position, mesh=mesh, in_specs=P("data"), out_specs=P())(
                batch["tokens"], batch["labels"])
            with torch.no_grad():
                mean = {k: (grads[0][k] + grads[1][k] + grads[2][k] + grads[3][k])
                        / SPMD_POSITIONS for k in params}
                updates, ref_state = opt.update(mean, ref_state, ref, s)
                del mean
                ref = {k: ref[k] + updates[k] for k in params}
                del updates
                for k, p in params.items():
                    torch.testing.assert_close(master[k], ref[k], **ZERO_TOL)
                    torch.testing.assert_close(bf16[k].float(), ref[k], **ZERO_BF16_TOL)
                    worst = max(worst, float((master[k] - ref[k]).abs().max()))
                    p.copy_(master[k])
            del master
        return worst

    worst, launched = run_app(f"zero1 {SPMD_POSITIONS} positions {ZERO_STEPS} steps", counts,
                              steps)
    log(f"zero1: fp32 master against replicated AdamW over {ZERO_STEPS} steps, max |diff| "
        f"{worst:.3e} (rtol {ZERO_TOL['rtol']}, atol {ZERO_TOL['atol']}); bf16 params within "
        f"{ZERO_BF16_TOL['rtol']}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    expect_launches("zero1 (its collectives are plain torch)", launched,
                    {"topk_compress_argmax": 0, "topk_compress_bitonic": 0,
                     "sparse_scatter_add": 0, "flash_attention": 0})
    del states, bf16, model, params       # (d)'s optimizer state goes first
    with torch.no_grad():
        flats = [pack_tree(g, spec) for g in grads]
    del grads
    return flats


def ef_run(flats: list, counts: dict) -> None:
    """(e): compressed_accumulate on each position's packed gradient of (d),
    at k = n/32 (32 a block: B) and n/4 (256: C).  Per position sent +
    residual == corrected bit for bit and the pairs are topk_compress's
    plain version's; the total is the plain densify of the positions' sent
    vectors' pairs in position order."""
    n = flats[0].numel()
    mesh = make_mesh((SPMD_POSITIONS,), ("data",), device="cuda")
    for div, body in EF_DIVISORS:
        k = n // div
        _, block_eff, per_block = block_layout(n, k)
        label = f"ef compressed_accumulate n={n} k=n/{div} ({per_block} a block)"
        outs, launched = run_app(label, counts, lambda: run_positions(
            mesh, lambda i: compressed_accumulate(flats[i], ef_init(n), "data", k)))
        other = next(b for _, b in EF_DIVISORS if b != body)
        expect_launches(label, launched, {body: 2 * SPMD_POSITIONS, other: 0,
                                          "sparse_scatter_add": SPMD_POSITIONS + 1})
        total = outs[0][0]
        sent_pairs = []
        for i, (total_i, ef) in enumerate(outs):
            if total_i is not total:
                raise AssertionError(f"{label}: position {i} got a total of its own")
            corrected = flats[i] + 0.0            # + the zero residual, as the call adds it
            pairs = blocked_topk_sparsify(corrected, k)
            plain = topk_compress_plain(corrected, per_block, block_eff)
            if not (torch.equal(pairs.idx, plain[0]) and torch.equal(pairs.vals, plain[1])):
                raise AssertionError(f"{label}: position {i}'s pairs differ from the plain "
                                     "version's")
            sent = densify(pairs.idx, pairs.vals, n)
            del pairs, plain
            if not torch.equal(sent + ef.residual, corrected):
                raise AssertionError(f"{label}: position {i}: sent + residual != corrected")
            sent_pairs.append(topk_compress_plain(sent, per_block, block_eff))
            del corrected, sent
        want = sparse_scatter_add_plain(torch.stack([p[0] for p in sent_pairs]),
                                        torch.stack([p[1] for p in sent_pairs]), n)
        if not torch.equal(total, want):
            raise AssertionError(f"{label}: the total differs from the plain densify")
        log(f"{label}: compression_ratio {compression_ratio(n, k):.4f}, wall "
            f"{WALLS[label]:.4f} s; sent + residual == corrected on every position, pairs "
            f"and total bit-equal to the plain versions")
        del outs, total, sent_pairs, want


def run_train() -> dict:
    """Phase 8 (train): every run of it on the card, any failure raises."""
    gc.collect()
    torch.cuda.empty_cache()
    counts: dict = {}
    weight_draw_times()
    train_full_qwen3(counts)
    pallas_backward_refused("qwen3-1.7b", {"attention_impl": "pallas"})
    torch.cuda.empty_cache()
    train_smoke_checks(counts)
    train_mamba_cut(counts)
    torch.cuda.empty_cache()
    flats = zero1_run(counts)
    gc.collect()
    torch.cuda.empty_cache()
    ef_run(flats, counts)
    del flats
    gc.collect()
    torch.cuda.empty_cache()
    train_full_zamba2(counts)
    for impl in ({"attention_impl": "pallas"}, {"ssd_impl": "pallas"}):
        pallas_backward_refused("zamba2-2.7b", impl)
    gc.collect()
    torch.cuda.empty_cache()
    train_moonshot_cut(counts)
    gc.collect()
    torch.cuda.empty_cache()
    card_vs_cpu("deepseek-v3-671b", counts)
    pallas_backward_refused("deepseek-v3-671b", {"attention_impl": "pallas"})
    torch.cuda.empty_cache()
    train_full_hubert(counts)
    card_vs_cpu(VLM, counts)
    for arch in (AUDIO, VLM):
        pallas_backward_refused(arch, {"attention_impl": "pallas"})
    # (j) QKV bias's gradients on the card (starcoder2 also LayerNorm and
    # the GELU FFN's biases)
    for arch in ("starcoder2-3b", "qwen2-72b"):
        card_vs_cpu(arch, counts)
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# Phase 9: mesh — expert parallelism over mesh positions, build_cell, the
# dry run and collective accounting
# ---------------------------------------------------------------------------

EP_ARCH, EP_LAYERS = "moonshot-v1-16b-a3b", 24      # phase 7's cut, every width as published
EP_MESH = dict(data=2, model=4)                      # 8 positions, 16 of 64 experts each
EP_GAP = 1e-4                                        # of max |logit|, EP against gather
EP_TRAIN_MESH = dict(data=2, model_axis=2)
DRYRUN_LIMIT_S = 60.0


def ep_analytic_bytes(cfg, tokens: int, mesh) -> dict:
    """One forward's collectives of each position under moe_impl="ep":
    per MoE layer, two all-to-alls of (E, C, D) fp32 buffers, an all-gather
    of the position's (chunk, D) output and an all-reduce of its fp32 aux."""
    n_moe = cfg.n_layers - cfg.first_dense_layers
    chunk = tokens // mesh.shape["data"] // mesh.shape["model"]
    c = max(1, int(np.ceil(cfg.top_k * chunk / cfg.n_experts * cfg.capacity_factor)))
    return {"all-to-all": n_moe * 2 * cfg.n_experts * c * cfg.d_model * 4,
            "all-gather": n_moe * chunk * cfg.d_model * 4, "all-reduce": n_moe * 4}


def ep_prefill(counts: dict) -> None:
    """(a) and (b): moonshot-v1-16b-a3b at EP_LAYERS of 48 layers, fp32,
    through build_cell on an EP_MESH mesh of positions on the card."""
    cfg = get_arch(EP_ARCH).replace(attention_impl="pallas", n_layers=EP_LAYERS,
                                    moe_impl="ep")
    mesh = make_host_mesh(**EP_MESH, device="cuda")
    shape = ShapeSpec("ep_prefill", LM_PREFILL, LM_BATCH, "prefill")
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, mesh, generator=SEED)
    torch.cuda.synchronize()
    model, (params, batch) = cell.model, cell.args
    log(f"mesh {EP_ARCH} ep: {cell.param_count} parameters, {cfg.n_layers} of "
        f"{get_arch(EP_ARCH).n_layers} layers, mesh {dict(mesh.shape)} ({mesh.size} "
        f"positions, {cfg.n_experts // mesh.shape['model']} experts each), capacity "
        f"{cfg.capacity_factor}, built in {time.perf_counter() - t0:.2f} s; a position holds "
        f"{cell.local_bytes['params'] / 2**30:.3f} GiB of parameters under the specs")
    prompt = prompt_of(batch)
    cell.step(params, prompt)                                # warm-up, not counted

    # (a) the prefill at B x T, its collectives recorded
    kernels = {"flash_attention": cfg.n_layers}
    label = f"mesh {EP_ARCH} ep prefill {LM_BATCH}x{LM_PREFILL}"
    with record_collectives() as rec:
        logits, launched = run_app(label, counts, lambda: cell.step(params, batch))
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect_launches(f"{EP_ARCH} ep prefill", launched, kernels)
    if logits.shape != (LM_BATCH, LM_PREFILL, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{EP_ARCH} ep prefill: logits not finite or of the wrong shape")
    del logits
    # both rates by run_app's wall (its collection and synchronize before it
    # left out), as phase 7 prints its gather path's
    gather_label = f"lm {EP_ARCH} prefill {LM_BATCH}x{LM_PREFILL}"
    beside = (f"{LM_BATCH * LM_PREFILL / WALLS[gather_label]:.1f} tokens/s, peak "
              f"{PEAKS[gather_label]:.3f} GiB" if gather_label in WALLS else "not run")
    log(f"mesh {EP_ARCH} ep prefill: {LM_BATCH * LM_PREFILL / WALLS[label]:.1f} tokens/s by "
        f"run_app's wall, peak device memory {peak:.3f} GiB; phase 7's gather path: {beside}")
    want = ep_analytic_bytes(cfg, LM_BATCH * LM_PREFILL, mesh)
    for linear in range(mesh.size):
        got = rec.stats(linear).bytes_by_op
        if got != want:
            raise AssertionError(f"ep prefill: position {linear} recorded {got}, the analytic "
                                 f"count is {want}")
    st = rec.stats(0)
    log(f"mesh {EP_ARCH} ep prefill collectives (each of {mesh.size} positions, equal to the "
        f"analytic count): {json.dumps(st.bytes_by_op)} bytes, wire "
        f"{json.dumps(st.wire_bytes_by_op)}, ops {json.dumps(st.count_by_op)}")

    # (b) EP against the gather path on the same weights, at E / k
    moe = model.moe_cfg
    model.moe_cfg = moe._replace(capacity_factor=moe.n_experts / moe.top_k)
    calls, hooks = moe_inputs(model)
    ep1, launched = run_app(f"mesh {EP_ARCH} ep forward {LM_BATCH}x{LM_CONSISTENCY}", counts,
                            lambda: cell.step(params, prompt))
    for h in hooks:
        h.remove()
    ep2 = cell.step(params, prompt)
    model.moe_cfg = moe._replace(capacity_factor=moe.n_experts / moe.top_k, impl="gather")
    plain, _ = run_app(f"mesh {EP_ARCH} gather forward {LM_BATCH}x{LM_CONSISTENCY}", counts,
                       lambda: cell.step(params, prompt))
    model.moe_cfg = moe
    if not torch.equal(ep1, ep2):
        raise AssertionError("ep forward: two runs on the card differ")
    delta = float((ep1 - plain).abs().max())
    scale = float(plain.abs().max())
    near = plain.topk(2, dim=-1).values
    ties = int(((near[..., 0] - near[..., 1]) <= 2 * delta).sum())
    flips = int((ep1.argmax(-1) != plain.argmax(-1)).sum())
    chunk = LM_BATCH * LM_CONSISTENCY // mesh.size
    loads = [expert_loads(mod, x, cfg_)[0] for mod, x, cfg_ in calls]
    log(f"mesh {EP_ARCH} ep vs gather at capacity E/k on {LM_BATCH}x{LM_CONSISTENCY}: max "
        f"|dlogit| {delta:.3e}, max |logit| {scale:.3e}, ratio {delta / scale:.3e} (limit "
        f"{EP_GAP}); argmax differs at {flips} of {LM_BATCH * LM_CONSISTENCY} positions, "
        f"{ties} positions with the top two logits within 2 max |dlogit|; EP bit-equal run "
        f"to run; largest expert load a data group {max(int(l.max()) for l in loads)} over "
        f"{len(loads)} MoE layers (gather C {capacity(model.moe_cfg._replace(capacity_factor=moe.n_experts / moe.top_k), LM_BATCH * LM_CONSISTENCY)}"
        f", EP C a position {chunk}: neither drops)")
    if not delta <= EP_GAP * scale:
        raise AssertionError(f"ep forward: {delta:.3e} off the gather path's (max |logit| "
                             f"{scale:.3e})")
    del cell, model, params, batch, prompt, ep1, ep2, plain, calls, loads
    gc.collect()
    torch.cuda.empty_cache()


def ep_training(counts: dict) -> None:
    """(c): moonshot's smoke_config with moe_impl="ep": train(data=2,
    model_axis=2) from SEED on the CPU and on the card (``card_vs_cpu``),
    then one backward through an EP layer on the card."""
    with arch_cut(EP_ARCH, moe_impl="ep"):
        card_vs_cpu(EP_ARCH, counts, **EP_TRAIN_MESH)
    cfg = smoke_config(get_arch(EP_ARCH)).replace(moe_impl="ep")
    shardings.set_mesh_axis_sizes(make_host_mesh(EP_TRAIN_MESH["data"],
                                                 EP_TRAIN_MESH["model_axis"], device="cuda"))
    model = build_model(cfg, generator=SEED, data_groups=EP_TRAIN_MESH["data"])
    model.requires_grad_(True)

    # one backward through an EP layer: finite, nonzero gradients
    blk = next(b for b in model.segments["seg1"])
    x = InitStream(SEED).draw((TRAIN_BATCH, 16, cfg.d_model), device="cuda").requires_grad_()
    for t in blk["moe"].parameters():
        t.grad = None
    y, aux = blk["moe"](x, model.moe_cfg)
    (y.square().mean() + aux).backward()
    grads = {n: t.grad for n, t in blk["moe"].named_parameters()} | {"x": x.grad}
    bad = [n for n, g in grads.items() if g is None or not bool(torch.isfinite(g).all())
           or not bool(g.abs().sum() > 0)]
    if bad:
        raise AssertionError(f"ep backward: gradients missing, non-finite or zero: {bad}")
    log(f"mesh ep backward on the card: {len(grads)} gradients finite and nonzero")
    del model, blk, x, y, grads


def ep_dryrun() -> None:
    """(d): deepseek-v3-671b's prefill_32k cell on meta over the production
    mesh (256 positions), its RooflineRecord on the H100's constants."""
    out_dir = os.path.join(build.BUILD_DIR, "dryrun")
    for arch in ("deepseek-v3-671b", EP_ARCH):
        t0 = time.perf_counter()
        rec = dryrun.run_cell(arch, "prefill_32k", "single", out_dir=out_dir, verbose=False)
        wall = time.perf_counter() - t0
        log(f"mesh dryrun {arch} prefill_32k single: wall {wall:.1f} s; {rec.summary()}")
        log(f"mesh dryrun {arch}: flops/dev {rec.hlo_flops:.4e}, bytes/dev {rec.hlo_bytes:.4e}, "
            f"collective bytes/dev {rec.collective_bytes:.4e}, args {rec.arg_bytes / 2**30:.3f} "
            f"GiB, out {rec.out_bytes / 2**30:.3f} GiB, model flops {rec.model_flops_total:.4e}; "
            f"note: {rec.note}")
        if wall <= DRYRUN_LIMIT_S:
            break
        log(f"mesh dryrun {arch}: {wall:.1f} s is past {DRYRUN_LIMIT_S} s; {EP_ARCH} next")


def run_mesh() -> dict:
    """Phase 9 (mesh): expert parallelism over mesh positions on the card."""
    gc.collect()
    torch.cuda.empty_cache()
    counts: dict = {}
    saved = (dict(shardings._AXIS_SIZES), shardings.CURRENT_MESH)
    try:
        ep_prefill(counts)
        ep_training(counts)
    finally:
        shardings._AXIS_SIZES, shardings.CURRENT_MESH = saved
    gc.collect()
    torch.cuda.empty_cache()
    ep_dryrun()
    return counts


def report_exports() -> None:
    """scripts/torch_make_report.py's ``--export-check`` and
    ``--export-trace`` on the card, into build/report: the four analytics
    apps armed with no finding and the seeded race caught (one read-write
    and one write-write finding); the traced 2-thread logreg fit's 50 spans
    in repro's four categories (15 store-op, 15 accumulate-round, 10
    barrier-wait, 10 app-round)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "torch_make_report.py")
    spec = importlib.util.spec_from_file_location("torch_make_report", path)
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    out = os.path.join(build.BUILD_DIR, "report")
    os.makedirs(out, exist_ok=True)
    check_json, trace_json = os.path.join(out, "check.json"), os.path.join(out, "trace.json")
    t0 = time.perf_counter()
    report.main(["--export-check", check_json])
    with open(check_json) as f:
        found = json.load(f)
    apps = {name: rep["count"] for name, rep in found["apps"].items()}
    kinds = sorted(f["kind"] for f in found["seeded_race"]["findings"])
    log(f"report --export-check on the card: {time.perf_counter() - t0:.2f} s; findings per "
        f"app {apps}, the seeded race {kinds}")
    if apps != {"logreg": 0, "kmeans": 0, "nmf": 0, "pagerank": 0} or kinds != [
            "read-write", "write-write"]:
        raise AssertionError(f"report --export-check: apps {apps}, seeded race {kinds}")
    t0 = time.perf_counter()
    report.main(["--export-trace", trace_json])
    with open(trace_json) as f:
        spans = collections.Counter(e["cat"] for e in json.load(f)["traceEvents"]
                                    if e["ph"] == "X")
    log(f"report --export-trace on the card: {time.perf_counter() - t0:.2f} s; spans "
        f"{dict(spans)}")
    if spans != {"store-op": 15, "accumulate-round": 15, "barrier-wait": 10, "app-round": 10}:
        raise AssertionError(f"report --export-trace: spans {dict(spans)}")
    if stepcheck.armed_count() or telemetry.armed_count():
        raise AssertionError("report exports left a checker or a tracer armed")


def log_kernel(name: str, m: dict) -> None:
    log(f"kernel {name} [{m['shape']}]: {m['ms']:.4f} ms, plain {m['plain_ms']:.4f} ms, "
        f"bound {m['bound_ms'] * 1e3:.2f} us ({m['bound_by']}), "
        f"library {m['library_ms']} ms, max_abs_err {m['max_abs_err']}; device time by "
        f"graph replay {m.get('device_ms')} ms, library's {m.get('library_device_ms')} ms")


def main() -> None:
    started = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; none is visible")
    smi = card_info()
    log("card:", smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    # the plain versions' matmuls must run in full fp32 (PyTorch's default)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(build.SOURCES)} sources")
    for lib, label, marker in (("flash_attention", "flash_attention_f32", "flash_tf32_kernel"),
                               ("flash_attention", "flash_attention_bf16", "flash_wgmma_kernel"),
                               ("topk_compress", "topk_compress_argmax", "topk_list_kernel"),
                               ("topk_compress", "topk_compress_bitonic", "topk_radix_kernel"),
                               ("fused_scatter", "fused_topk_scatter", "fused_radix_kernel"),
                               ("scatter_add", "sparse_scatter_add", "scatter_rows_kernel"),
                               ("ssd_scan", "ssd_scan", "ssd_chunk_kernel")):
        for line in ptxas_lines(logs.get(lib, ""), marker):
            log(f"{label} ptxas:", line)

    rng = np.random.default_rng(SEED)
    measured = check_kernels(rng)
    measured["flash_attention"] = check_flash(rng)
    measured["ssd_scan"] = check_ssd(rng)
    shapes = check_zamba2_shapes(rng)
    shapes.update(check_moe_shapes(rng))
    shapes.update(check_vlm_audio_shapes(rng))
    shapes.update(check_dense_shapes(rng))
    measured.update(check_receive(rng))
    measured["flash_attention_bf16"] = check_flash_bf16(rng)
    check_inputs(rng)
    g_split(rng)
    h_split(rng)
    b_split(rng)
    f_timings(rng)
    a_timings(rng)
    for name, m in {**measured, **shapes}.items():
        log_kernel(name, m)

    count_draws()
    keep: dict = {}
    counts = run_apps(keep)
    for name in ("pagerank_credits", "logreg_margin", "nmf_init", "nmf_products_rqt",
                 "nmf_products_ptr"):
        measured[name] = keep.pop(name)
        log_kernel(name, measured[name])
    for name, n in run_armed(keep).items():
        counts[name] = counts.get(name, 0) + n
    report_exports()
    for name, n in run_ft(keep).items():
        counts[name] = counts.get(name, 0) + n
    for name, n in run_lm(shapes).items():
        counts[name] = counts.get(name, 0) + n
    for name, n in run_train().items():
        counts[name] = counts.get(name, 0) + n
    for name, n in run_mesh().items():
        counts[name] = counts.get(name, 0) + n
    draw_summary()
    log(f"chip_smoke.py wall {time.perf_counter() - started:.1f} s, the build included")
    missing = [name for name in KERNELS if counts.get(LAUNCH_COUNTER.get(name, name), 0) == 0]
    if missing:
        raise AssertionError(f"the main path never launched {missing}")

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": counts[LAUNCH_COUNTER.get(name, name)],
         **{key: measured[name][key] for key in
            ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         **{key: measured[name][key] for key in GRAD_KEYS if key in measured[name]}}
        for name, (src, replaces) in KERNELS.items()]}
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
