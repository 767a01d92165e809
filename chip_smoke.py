#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, training and data paths on one
NVIDIA GPU (sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. Phases (each prints one line, any
failure ends the run with a non-zero exit code):

1.  card     — device name, visible cards, name + power limit from
               nvidia-smi (the run uses one card, cuda:0);
2.  build    — nvcc builds every kernel of mamimo_tpu_torch/csrc (one
               process per source, all at once); prints the ptxas
               report, and checks with cuobjdump that the layer-1 GEMMs
               and factored_dense, the MLP tails (factored_rows_tail
               too) and the three LS kernels
               (ls_planes_v2_kernel, each of its four variants: f32 or
               bf16 store, with or without the sums of h^2;
               ls_planes_v1_kernel, ls_pair_kernel), their float32 modes
               (ls_planes_v2_f32_kernel, ls_planes_v1_f32_kernel,
               ls_pair_f32_kernel), the float GEMMs (mm_bf16_kernel,
               mm_tf32x3_kernel) and the DNN kernels' float32 modes
               (factored_sig_proj_f32_kernel, its split walk
               factored_sig_proj_split_f32_kernel, factored_dense_f32_
               kernel, factored_rows_tail_f32_kernel, mlp_layer1_f32_
               kernel, mlp_tail_f32_kernel) run wgmma (HGMMA) and
               no mma.sync (HMMA), and the int8
               GEMM (int8_mm_kernel_slab, int8_mm_kernel_ring) int8
               wgmma (IGMMA) and no int8 mma.sync (IMMA);
3.  kernels  — each hand-written kernel against its plain PyTorch version
               on the same inputs, at the full BS32 width (Nt=32, Nr=4,
               hidden 1024/1024, len_ltf 10240), S = 256 rows; then at
               S = 28 and on a small config (Nt=8, hidden 128, S = 11),
               where the last tiles are partly empty. The int8 GEMM is
               held to its float64 plain version exactly, at the three
               layer shapes with a ragged M. The per-pair LS takes whole
               packets (64, 7 and 7) of time-major preambles; the fused
               MLP takes S*Nt - 3 materialized rows. The two layer-1
               GEMMs (factored_sig_proj, mlp_infer_layer1) also run at 1
               row, at S*Nt - 3 rows and at a K that is not a multiple
               of their 64-wide k-step; the tails at their edges
               (factored_tail at S = 1, S = 65 and 3 heads, so that a
               cluster's last block lies past the heads; mlp_infer_tail
               at 1 row, a cluster's last block past M); float32 (not
               bf16-valued) planes go through ls_planes_v2 and
               sharded_ls_pallas_v2. The two Hopper LS kernels also run
               at their tile edges: S = 1, S = 5 (the last 128-row tile
               partly past the rows), seq ranks of n = 2, 4 and 32 (one
               symbol a rank; the sum of all partials within -100 dB of
               the full kernel), 1 and 3 packets per pair, Nt = 8 at
               S = 1 and Nt = 128 at S = 3 (one sample a tile, the
               despread's shuffle stages); constants of the other layout
               are refused. The v1 LS kernel runs at S = 1, 3 and 33 on
               Nt = 8, 32 and 128, both output dtypes, block_samples 8
               and 1 (the last tile partly past s_out), pads exactly
               zero; the int8 GEMM bit-exact at M = 1, 129 and S*Nt - 3,
               N = 8, 234 and 1024, K = 16, 1024 (its resident-slab body)
               and 1040 (its ring body, a K tail). ls_planes_v2's bf16 store and
               per-tile sums of h^2 (out_dtype=bfloat16, with_ssq) run
               at S = 256, 1 and 5, full mode and seq ranks of n = 2 and
               4: the estimate within -45 dB of the float32 plain
               version, the sums within 1e-4 relative per tile of the
               plain version's on the kernel's own bf16 constants, the
               same sums from a second call (no atomics);
4.  physics  — the sounding preamble through random flat channels, no
               noise: the served LS must recover every channel on every
               carrier;
5.  serving  — a glorot-initialized model (seeded torch.Generator) saved
               as an npz checkpoint, loaded by CSIPredictor on the card,
               answers 3 requests of 64 packets through estimate_full;
               every kernel's launch count must have risen during them;
5b. int8     — the same predictor answers 3 requests of 64 packets
               through all_pairs(int8=True); the int8 GEMM must have
               launched, and the first answer is held to the float32
               all-pairs DNN and to the int8 path on the CPU;
5c. planes   — each of the four bf16-input bench paths of
               mamimo_tpu_torch/bench.py answers once; every kernel it
               names must have launched;
5d. per pair — the bench path pallas_full (make_estimation_fn with
               use_pallas, from_planes) answers 3 requests of 64 packets
               of float32 planes: the per-pair LS kernel and the fused MLP
               on the materialized input must have launched; the first
               answer is held to the float32 branch (factored DNN), and
               its first 3 packets' DNN to the plain float32 chain on
               their materialized rows. predict_complex_pallas answers
               256 rows, held to the float32 predict_complex;
5e. seq-par. — the sequence-parallel path on a mesh of virtual ranks,
               all on the one card (cuda:0): the halo-exchange kernel,
               one launch for all ranks of the card, on the padded BS32
               preamble's 4 rank chunks with the 512 taps of a seeded
               scattering realization, as planes and as complex64 rows,
               then on its scalar path (rows of 3 and 6 floats, a 4-byte
               offset), rows of 1028 floats, halo 0 and 8 ranks (each
               exact against the plain exchange, rank 0's halo zero), the
               sharded FIR
               convolution sharded_apply_channel_rdma (against the
               unsharded one and the exact phase-ramp channel), the
               sharded LS sharded_ls_pallas_v2 in seq (2, 4 ranks) and
               data (4 ranks) modes, and the sharded inference forms
               (sharded_ls_estimate, sharded_predict_all_pairs,
               sharded_estimate_combined on data 2 x seq 2 x antenna 2)
               against their unsharded float32 counterparts;
5f. bench    — the headline bench path pallas_ls_v2_serving_r3
               (make_estimation_fn_serving_r3) answers 3 requests of 64
               packets of bf16 planes: ls_planes_v2 and the fused
               factored kernels must have launched; the first answer's
               sums of h^2 and DNN planes are held to the float32 plain
               path; entry() runs once (its LS held to the float32 LS);
               run_bench (64 packets, 2 calls a window) yields a line
               with all 16 paths; the path pallas_factored once, counted
               (its factored_tail launches are kernel 2's bf16 store);
5g. train    — the training step (train/loop.py) at the full BS32 width,
               a seeded model and a seeded 64-packet device dataset: one
               f32 and one bf16 step (method 'default', dropout 0) on the
               card held to the same step on the CPU (loss, BN
               statistics, gradients, Adam moments, Δparams; limits in
               TRAIN_LIMITS); 32 steps on one fixed batch, AWGN off, whose
               loss must fall (the step reaches no TPU kernel: the
               kernels' launch counts are read around them and printed);
               one train_step.multi of the default configuration
               (rbg_clt, dropout 0.15, default_snr), finite;
               run_train_bench at 2 calls, a row for every default
               variant;
5h. sounding — the sounding path at BS32 (ops/ofdm.py, the LS forms and
               LMMSE forms of ops/estimate.py, channel/noise.py,
               channel/cdl.py, pipeline/sounding.py, pipeline/dataset.py):
               (a) the OFDM round trip of 64 packets' grids; (b) on 64
               sounded packets the FFT-form LS against the matmul and
               rx-major forms (-100 dB) and the per-pair LS kernel on the
               same rx (-50 dB); (c) the dense, direct, eigenbasis,
               chunked and CG LMMSE against a float64 solve at -10, 0 and
               20 dB (2e-4 of the scale; CG 2e-3), and the CG against the
               direct solve at 30, 40 and 120 dB (2e-3, 8e-3, 3e-3); (d)
               generate_dataset on the card (128 packets, chunk 64, 10 dB,
               CG labels): finite, realized SNR within 1 dB, LMMSE NMSE
               below LS's, the same at chunk 32 (draws identical, arrays
               within -100 dB), a packet regenerated alone from
               packet_generator, the CPU port on 4 packets from the same
               draws (2e-2 relative) and from the card's realization (-80
               dB), the first chunk fetched synchronously (-100 dB); (e)
               the nf and sinr receivers and the cdl_nlos and cdl_los
               channels on 8 packets each, finite and held to the CPU the
               same two ways; (f) the corpus's planes (S = 512) through
               estimate_full, one launch of each of its kernels, its LS
               within -50 dB of the corpus's; (g) run_gen_bench at 128
               packets, four modes with positive rates;
5i. pipeline — the training pipeline at BS32, TF32 off: (a) 128 packets
               at 120 dB generated on the card, written as the raw
               container; the native C++ loader in use, its gather,
               gather_packets and prefetch/wait bit-equal to the NumPy
               plain version; (b) fit for 3 epochs in the in-HBM mode
               (steps_per_call 4) and the host_stream mode from one
               epoch-0 checkpoint (method 'default', dropout 0, batch
               1024): histories within 1e-5 relative; window streaming
               (32 packets a window): finite, the training loss falling;
               (c) with the AWGN on (rbg_clt, dropout 0.15) 2 epochs and
               a resume to 3 against 3 straight (1e-6); (d) at Nt 8, Nr
               2, hidden (64, 64) the card's fit against the CPU's from
               one checkpoint (1e-4), ReLU flips counted; (e)
               evaluate_dataset and nmse_vs_snr on 64 packets at 10 dB,
               finite; (f) the trained 'best' checkpoint through
               CSIPredictor.estimate_full: one launch of ls_planes_v2,
               factored_sig_proj and factored_tail, the DNN within -40 dB
               of evaluate_dataset's prediction, the LS within -45 dB of
               the corpus's h_ls; (g) python3 -m mamimo_tpu_torch.cli gen
               -> train -> test (--export-mat --exec-time) at Nt 8 on the
               card as subprocesses, each exiting 0, test_report.json
               written;
5j. closed   — the closed loop at BS32 (500 rays, 10 data symbols, the
    loop       data leg's FFT 16384): (a) 32 packets with LMMSE labels at
               0 and 20 dB; (b) the DNN CSI of 5i's trained checkpoint
               through estimate_full, one launch of each of its kernels,
               within -40 dB of evaluate_dataset; (c)
               evaluate_closed_loop over ls, lmmse, dnn and perfect:
               finite, at 20 dB perfect CSI with mean BER < 1e-2 and mean
               BF gain > 3 dB, a table of BER, EVM, NMSE and BF gain; (d)
               2 packets sounded on the CPU: the OMP weights on the card
               and on the CPU (1e-4, the digital ones up to the SVD's
               phase per carrier), then the data leg of the CPU's weights
               on each: decoded bits equal, EVM 1e-4 relative, SNR 1e-4
               dB; (e)
               generate_dataset(with_ber=True): the sounding bit-equal to
               (a)'s; (f) run_mu_snr_sweep, 2 users (a placement the
               array separates), 8 packets, ls and perfect at 30 dB:
               perfect CSI decodes every user with BER 0; (g) the CLI's
               sweep --closed-loop (5i's Nt 8 model as the DNN) and
               sweep --num-users 2 as subprocesses at Nt 8;
5k. sharded — the DP+TP training step and the multi-host layer on 4
    training  virtual ranks of cuda:0 at BS32 (hidden 1024 x 1024): (a) one
               step on data 2 x model 2 and on data 4 at batch 1024 against
               the card's single-card step (TRAIN_LIMITS["f32"]; ReLU
               pre-activations of another sign counted); (b) a 2-epoch
               fit(mesh=data 2 x model 2) in the in-HBM, host_stream and
               window modes on 5i's corpus, each against the single card's
               fit in that mode; (c) dryrun_multichip(4) on the virtual
               ranks (one DP+TP step, the sharded LS and inference forms,
               the plain and the kernel halo exchange, the LS kernel in
               data and seq modes): the LS and halo kernels must launch;
               (d) a hidden (64, 64) model, its weights padded to 128
               units, served through predict_complex_pallas (kernel 5)
               against the kernels' plain version;
5l. wide     — every model the port trains, served on the card: BS32 at
    models     hidden (2048, 2048), (4096, 1024), (1536, 640), (1024,)
               and (1024, 1024, 1024) (the per-head rows through device
               memory, the bf16 rows tail as two GEMMs, counted), and Nt
               256, Nr 4, hidden (1024, 1024) at 128 packets (kernel 1's
               halves body, one sample a unit); each a seeded checkpoint
               loaded by CSIPredictor, one request through estimate_full and
               one through all_pairs, launches of kernels 1 and 2
               counted, the served estimates within PIPE_LIMITS of the
               float32 path, each kernel of the depth's chain against
               its plain version (factored_rows_tail and factored_dense
               at ragged rows and 1 row too, factored_dense's output
               layer's bf16 store exactly its f32 result rounded,
               factored_heads bit for bit the plain version's bf16 rows
               with its product and sum in one rounding); at Nt
               256 kernel 1's bf16 store and sums (check_v2_modes, S =
               512 and 5), S = 1, a seq rank, kernels 3 and 4 (4 in both
               modes: ls_estimate_pallas, and bf16 pair planes), and the
               paths pallas_ls_v2_serving_r3 and ls_pallas counted; at
               (2048, 2048) kernel 5 through predict_complex_pallas;
               then each new kernel shape timed (CUDA events, S = 4096
               at BS32, 512 at Nt 256) beside its plain version, bound
               and library yardstick, rows of the kernels line
               (factored_dense held to its plain version at that shape
               first); last, where the toolkit has compute-sanitizer, a
               memcheck of the two-GEMM route at H2 % 256 = 128
               (tools/memcheck_route.py);
5m. float32 — float32 planes through kernels 1 (full and seq, f32 and
               bf16 store, sums of h^2), 3 (raw, complex, as_planes) and
               4 (complex64 rx) in their float32 mode at BS32 (S = 256
               and 5), Nt 8 and Nt 256, each within -90 dB of its
               float32 plain version (TF32 off; the bf16 mode's dB on
               the same planes printed beside), the bf16 stores exactly
               the float32 result rounded, as_planes exactly the complex
               form; NaN and +-Inf samples non-finite where the plain
               version's values are, the rest within -90 dB;
               sharded_ls_pallas_v2 data and seq on 4 virtual
               ranks on float32 planes within 1e-4 of the unsharded
               float32 plain LS (float32 launches counted; phase 5k's
               dryrun_multichip must launch the float32 mode too);
               matmul_pallas on bf16 and float32 operands within -90 dB
               of float64 products (bf16: B (K, N) as given, a
               transposed view, N % 8 != 0), out_dtype=bf16 the float32
               result rounded; then holds kernels 1 and 3's float32 modes at S
               = 4096 within -90 dB of their plain versions and times
               them there, kernels 1, 3 and 4's at Nt 256 and S = 512
               (the halves body) the same way, and kernel 6 at (4096,
               10240) @ (10240, 1024) and
               (131072, 1024) @ (1024, 1024), rows of the kernels line
               (kernel 4's float32 mode is phase 6's pallas_full row);
5n. f32 DNN  — BS32 models with float32 weights, hidden (1024, 1024),
               (1024,), (1024, 1024, 1024) and (2048, 2048), served
               through predict_all_pairs_planes_kernel (16 packets) and
               the two-layer ones through predict_complex_pallas
               (dot_dtype=float32, 256 rows), every float32 kernel of
               the path counted ("<name> f32") and the served estimates
               within -90 dB of the float32 plain model (TF32 off; the
               bf16 mode's dB on the same weights printed beside);
               fused_factored_planes' out_dtype=bfloat16 exactly the
               float32 result rounded, both modes; each float32 kernel
               (factored_sig_proj, factored_heads, factored_dense,
               factored_rows_tail, mlp_infer_layer1, mlp_infer_tail)
               against its plain version at S = 256, 1, 5, 65 and 3
               heads (S*32 - 3, 1 and 65 rows for kernel 5), the ReLU
               flips of its rows counted, and every output kernel's bf16
               store exactly its float32 result rounded; phase 6 times
               each float32 kernel at S = 4096 beside its plain version,
               bound and a float32 torch.matmul / bmm (TF32 off), rows
               of the kernels line, and the fused tail's bf16 store
               beside its float32 one;
5o. LS shapes— kernels 1, 3 and 4 at every num_tx and cp_length a JAX
               configuration takes (the general body, ls_body<0>): Nt
               512 (128 packets, four 128-symbol parts a sample), Nt
               1024 (32 packets, eight), BS32 at cp 18 (NR's normal
               prefix at FFT 256) and cp 9 (map rows of 4 and 8
               symbols, each box shifted into place), in both modes:
               kernel 1 bf16 (f32 store; bf16 store and sums) and
               float32 (its bf16 store exactly the float32 result
               rounded, its sums), at S = 5 and 1, seq ranks of 2 and 4
               whose partials sum to the estimate; kernel 3 raw, complex
               and as_planes; kernel 4 on bf16 pair planes and complex64
               rx; each within -45 dB (bf16) or -90 dB (float32) of its
               plain version, counted; sharded_ls_pallas_v2 at Nt 1024
               (seq 2, seq 4, data 4 on 4 virtual ranks);
               estimate_full with a (1024, 1024) model at Nt 512 and at
               cp 18 within PIPE_LIMITS of the float32 path; kernel 2 at
               Nt 1024 (fused tail and per-head rows bf16, the float32
               rows route); one Nt 1024 call at 1024 packets (2.68e9
               input elements) whose last 8 samples are held to the
               plain version on them alone; phase 6 times each kernel at
               Nt 512, Nt 1024 and BS32 cp 18 (S = 4096) in both modes,
               rows of the kernels line. At 512 symbols a sample and
               more the LS kernels first launch the part transform
               (ls_parts, counted): held bit for bit to its plain
               version at Nt 512 and 1024, both modes and a seq rank;
               there kernels 1, 3 and 4 are held to -52 dB (bf16; -50
               for kernel 3's bf16 store) and -100 dB (float32); estimate_full also at Nt 1024 and at
               Nt 2048 (2 packets, hidden (128, 128)); kernel 2's layer
               1 split across the card (counted "factored_sig_proj
               split") at Nt 1024 (S = 128) and Nt 512 (S = 512) within
               -85 dB of float32 x @ W1, two launches bit-identical, its
               ranges printed, and BS32's layer 1 in one range; its
               float32 mode split there too (counted "factored_sig_proj
               split f32"; the float32 rows route at Nt 1024 and 512)
               within -90 dB of float32 x @ W1, two launches
               bit-identical; phase 6 rows of the transform and of the
               split layer 1 in both modes;
6.  timing   — each kernel, its plain version and a library yardstick at
               the bench shape (1024 packets, S = 4096), CUDA events (the
               LS kernel also in its bf16-store-and-sums variant;
               kernel 4's float32 mode first held within -90 dB of
               ls_estimate_matmul on float32 planes there); the
               device time of estimate_full, all_pairs(int8=True), the
               four planes paths, pallas_ls_v2_serving_r3 and
               pallas_full, and pallas_full's peak
               device memory; the LS kernel's seq mode per rank; the
               halo kernel's device time for one whole 4-rank exchange
               from a profiler trace; the host time per call of
               halo_exchange_pallas, sharded_apply_channel_rdma, the
               plain-exchange sharded_apply_channel and
               sharded_ls_pallas_v2 (seq, 4 ranks; on float32 planes
               also data, 4 ranks: kernel 1's float32 mode, first held
               within 1e-4 of the float32 plain LS) beside each
               call's traced device-busy time; the training step: the
               line of run_train_bench (f32, bf16, f32_rbg at batch 256 and
               1024: ms/step, steps/s, samples/s, achieved TFLOP/s)
               beside each step's bound, and one 16-step .multi call per
               row traced (device-busy ms) beside its host time, the
               device-idle share; the sounding path: run_gen_bench's line
               (512 packets, chunk 64), one generate_dataset call of 128
               packets ('ls' and 'lmmse') on the host clock beside its
               traced device-busy time and idle share, one chunk of 64
               through sound_from_draws traced (largest kernels), each
               LMMSE form at 64 packets (CUDA events), the bench path
               ls_fft at the bench shape; the training pipeline: fit's
               seconds per epoch and steps/s in each of its three modes
               (128 packets, batch 1024, with a workdir), one epoch of
               each traced (device-busy ms beside its host ms, the idle
               share), one epoch's checkpoint writes, and
               evaluate_dataset in packets/s at 4 and 32 packets a batch;
               the closed loop: one chunk of evaluate_closed_loop (32
               packets x 4 sources) on the host clock beside its traced
               busy time, idle share, kernels and aten calls, its parts
               (OMP with the SVD, the channel, the receiver, the Viterbi
               loop alone) on the same inputs, packets x sources per
               second, and run_gen_bench's with_ber rate; the sharded
               training step: one f32 step at batch 1024 on the single
               card, on data 2 x model 2 and on data 4 (4 virtual ranks),
               ms/step on the host clock beside the traced device-busy
               time, idle share, kernels and aten calls per step.

Launch counts are set to 0 just before each main-path call of phases 5,
5b, 5c, 5d, 5e, 5f, 5g, 5h, 5i, 5j, 5k, 5l, 5m, 5n and 5o and read just
after
(the wrappers with a float32 mode also count its launches apart, "<name>
f32"); estimate_full,
pallas_ls_v2_serving_r3 and pallas_full are also traced
(torch.profiler: each kernel's own device time in the call). Prints a JSON line of per-kernel numbers before the
last line, which is {"ok": true, "device": {...}}. Needs a CUDA GPU and
the repository's sources; exits non-zero without either.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_FLOPS = 989e12                # H100 SXM bf16 dense tensor cores
INT8_OPS = 1979e12                 # H100 SXM int8 dense tensor cores
S_CHECK = 256                      # rows of the kernel checks (64 packets)
MAT_PACKETS = 3                    # packets of the plain materialized check
BENCH_PACKETS = 1024               # the bench shape: S = 4096
FP32_FLOPS = 67e12                 # H100 SXM float32, no tensor cores
TRAIN_PACKETS = 64                 # the training bench's device dataset
TRAIN_BS = 256                     # the batch of the card-vs-CPU steps
SOUND_PACKETS = 64                 # phase 5h: the LS and LMMSE checks
GEN_PACKETS, GEN_CHUNK = 128, 64   # phase 5h: generate_dataset
GEN_SEED = 13
PIPE_PACKETS = 128                 # phase 5i: the training pipeline's corpus
PIPE_BS = 1024                     # phase 5i: fit's batch
PIPE_WINDOW = 32                   # phase 5i: packets a streamed window
PIPE_SEED = 23
CL_PACKETS = 32                    # phase 5j: the closed loop's corpora
CL_SNRS = (0.0, 20.0)              # phase 5j: their sounding SNRs (dB)
CL_SEED = 31
MU_PACKETS = 8                     # phase 5j: the multi-user sweep
# phase 5j's limits: at 20 dB perfect CSI decodes (mean BER) with a
# beamforming gain (dB), as JAX's tests/test_closed_loop.py at Nt 8; the
# card against the CPU on the same inputs: the OMP weights (relative, the
# digital ones up to the SVD's phase per carrier), then on the same
# weights EVM (relative) and the data-leg SNR (dB), the decoded bits equal
CL_LIMITS = {"perfect_ber": 1e-2, "perfect_bf_gain_db": 3.0,
             "weights_rel": 1e-4, "evm_rel": 1e-4, "snr_db": 1e-4}
# phase 5i's limits: two modes of fit on the same batches (relative, per
# epoch loss), a resumed run against the uninterrupted one, the card's fit
# against the CPU's at Nt 8 (a ReLU kink moves a sample's gradient share,
# see TRAIN_LIMITS), the served DNN (bf16 kernels) against the float32
# evaluate_dataset and the served LS against the corpus's labels (dB)
PIPE_LIMITS = {"modes_rel": 1e-5, "resume_rel": 1e-6, "card_cpu_rel": 1e-4,
               "served_dnn_db": -40.0, "served_ls_db": -45.0}
# phase 5k: the sharded step against the card's single-card step uses
# TRAIN_LIMITS["f32"] (the split products and sums move a few ReLU
# pre-activations across 0, as the card's against the CPU's); 2-epoch fits
# on the mesh against the single card's in each mode (relative, per epoch
# loss; Adam turns the sums' rounding into steps); a hidden-64 model served
# through kernel 5 against the kernels' plain version (dB)
MESH_LIMITS = {"fit_rel": 1e-3, "hidden64_db": -40.0}
MESH_RANKS = 4                     # phase 5k: virtual ranks of cuda:0
# phase 5g's limits, card step against the same step on the CPU: loss and
# BN statistics (relative), gradients and Adam moments (worst leaf, NMSE
# dB), Δparams (all parameters as one vector, NMSE dB). A ReLU is a kink:
# where the card's float32 forward (about 1e-5 from float64 at K = 10272,
# ten times the CPU's error) puts a pre-activation on the other side of 0,
# that sample's whole contribution to the layer's gradients changes; two
# such flips in the 524288 pre-activations of a layer move that layer's
# gradient leaves to about -45 dB, while the loss agrees to 1e-7 (see
# relu_flips). bf16: the card also rounds each incoming cotangent to bf16
# for the tensor cores (the CPU keeps it float32, models/mlp.py::
# Bf16Dense). The first Adam step is about -lr·sign(g), so elements whose
# |g| lies under the gradient error change sign: Δparams is far looser.
TRAIN_LIMITS = {"f32": {"loss": 1e-5, "bn": 1e-5, "grads_db": -35.0,
                        "moments_db": -35.0, "delta_db": -20.0},
                "bf16": {"loss": 1e-4, "bn": 1e-4, "grads_db": -30.0,
                         "moments_db": -30.0, "delta_db": -15.0}}
# ls_planes_v2_kernel's variants, by a piece of their mangled names:
# <float, false> is the default float32 store without sums
V2_VARIANTS = {"f32": "ls_planes_v2_kernelIfLb0E",
               "f32 + ssq": "ls_planes_v2_kernelIfLb1E",
               "bf16 out": "ls_planes_v2_kernelI13__nv_bfloat16Lb0E",
               "bf16 out + ssq": "ls_planes_v2_kernelI13__nv_bfloat16Lb1E"}


def nmse_db(got, ref) -> float:
    """NMSE of numpy arrays (real or complex) in dB, in float64."""
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    with np.errstate(divide="ignore"):          # an exact match is -inf
        return float(10 * np.log10(np.sum(np.abs(got - ref) ** 2)
                                   / np.sum(np.abs(ref) ** 2)))


def to_np(t):
    """A tensor on any device as a numpy array (bf16 widened to f32)."""
    t = t.detach()
    if t.dtype.is_floating_point and t.element_size() < 4:
        t = t.float()
    return t.cpu().numpy()


def finite(x):
    """x, or None where it is not finite (an exact match has NMSE -inf,
    which JSON cannot hold)."""
    return x if np.isfinite(x) else None


def check(name: str, got, ref, limit_db: float) -> dict:
    """Hold a kernel's output to its reference: NMSE <= limit_db and all
    values finite; raises otherwise."""
    import torch

    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    if got.is_cuda and ref.is_cuda:
        # in float64 on the card: the large outputs need no host copy
        wide = lambda t: (t.to(torch.complex128) if t.is_complex()  # noqa: E731
                          else t.double())
        g, r = wide(got), wide(ref)
        d2, r2 = float((g - r).abs().square().sum()), float(
            r.abs().square().sum())
        with np.errstate(divide="ignore"):     # an exact match is -inf
            db = float(10 * np.log10(d2 / r2))
        err, top = float((g - r).abs().max()), float(r.abs().max())
        del g, r
    else:
        got = to_np(got).astype(np.complex128)
        ref = to_np(ref).astype(np.complex128)
        db, err = nmse_db(got, ref), float(np.abs(got - ref).max())
        top = float(np.abs(ref).max())
    print(f"  {name}: NMSE {db:.2f} dB (limit {limit_db} dB), "
          f"max|err| {err:.3e}, max|ref| {top:.3e}")
    if not db <= limit_db:
        raise AssertionError(f"{name}: NMSE {db:.2f} dB > {limit_db} dB")
    return {"nmse_db": finite(db), "max_abs_err": err}


def check_exact(name: str, got, ref) -> dict:
    """Hold an integer kernel's output to its reference bit for bit."""
    import torch

    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)} {got.dtype} != "
                             f"{tuple(ref.shape)} {ref.dtype}")
    bad = int((got != ref).sum())
    print(f"  {name}: {'exact' if not bad else f'{bad} values differ'}")
    if bad:
        raise AssertionError(f"{name}: {bad} of {got.numel()} values differ")
    return {"nmse_db": None, "max_abs_err": 0.0, "exact": True}


def check_pads_zero(name: str, hr, hi, s: int, nt: int, c: int) -> None:
    """The raw LS planes' pad rows (samples >= s) and pad lanes (>= c)
    must be exactly zero."""
    for h in (hr, hi):
        if bool((h[s * nt:] != 0).any()) or bool((h[:, c:] != 0).any()):
            raise AssertionError(f"{name}: a pad row or lane is not zero")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms over `iters` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def host_ms(fn, iters: int = 10, batches: int = 5, warmup: int = 3):
    """Host time of fn() in ms per call, what a caller waits for a call
    whose time the host sets: the median over `batches` batches of
    `iters` back-to-back calls (the card synchronized before and after
    each) of the batch's mean (the host is shared; one batch can catch a
    stall)."""
    import torch

    for _ in range(warmup):
        fn()
    per = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) / iters * 1e3)
    return float(np.median(per))


def trace_kernels_ms(fn, calls: int = 3) -> dict:
    """Device time per call (ms) of each kernel fn() launches, by name,
    from a torch.profiler trace of `calls` back-to-back calls; {} when the
    trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    except RuntimeError as e:       # a measurement, not a check
        print(f"  torch.profiler failed: {e}")
        return {}
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", DeviceType.CUDA) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            out[e.key] = us / 1e3 / calls
    return out


def trace_call(fn) -> tuple:
    """One call of fn() traced on the host and the card, after one call
    untraced: ({kernel name: device ms}, the device kernels it ran, the
    aten operator calls it made, nested ones included); the first is {}
    when the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    per, kernels, aten = {}, 0, 0
    for e in prof.key_averages():
        if getattr(e, "device_type", DeviceType.CPU) == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                per[e.key] = us / 1e3
                kernels += e.count
        elif e.key.startswith("aten::"):
            aten += e.count
    return per, kernels, aten


def bound_ms(nbytes: float, ops: float, peak: float = BF16_FLOPS):
    """The least time for moving `nbytes` and doing `ops` at `peak`."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = ops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def int_mm_library(a, bt):
    """torch._int_mm on the GEMM's operands, the library yardstick (the
    port never calls it): B as (K, N), N padded to a multiple of 8 as its
    shape rules need."""
    import torch

    n = bt.shape[0]
    b = torch.zeros((bt.shape[1], -(-n // 8) * 8), dtype=torch.int8,
                    device=bt.device)
    b[:, :n] = bt.T
    return lambda: torch._int_mm(a, b)


def make_model(cfg, tcfg, seed: int, device, bf16_values: bool = True):
    """Glorot weights from a seeded generator, rounded to bf16 values so
    the float32 references and the bf16 kernels share them (unless
    bf16_values is False: float32 weights for the float32 modes), and a
    non-trivial BN state (so the folded affines matter)."""
    import torch

    from mamimo_tpu_torch.models.mlp import init_stacked, tree_map

    g = torch.Generator().manual_seed(seed)
    params, bn = init_stacked(g, cfg, tcfg)
    for lyr in params["dense"] + [params["out"]]:
        if bf16_values:
            lyr["w"] = lyr["w"].to(torch.bfloat16).float()
        lyr["b"] = 0.05 * torch.randn(lyr["b"].shape, generator=g)
    for i, b in enumerate(params["bn"]):
        b["scale"] = 0.5 + torch.rand(b["scale"].shape, generator=g)
        b["bias"] = 0.1 * torch.randn(b["bias"].shape, generator=g)
        bn["mean"][i] = 0.1 * torch.randn(bn["mean"][i].shape, generator=g)
        bn["var"][i] = 0.5 + 1.5 * torch.rand(bn["var"][i].shape, generator=g)
    to = lambda t: t.to(device)                              # noqa: E731
    return tree_map(to, params), tree_map(to, bn)


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref| of tensors on any device."""
    got, ref = to_np(got).astype(np.float64), to_np(ref).astype(np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def relu_flips(tcfg, pa, pb, xa, xb) -> list:
    """Per hidden layer, the pre-activations (train-mode forward, batch BN
    statistics) whose sign differs between two runs of the same model:
    parameters pa, pb and model inputs xa, xb on two devices."""
    import torch

    flips = []
    for i in range(len(pa["dense"])):
        za, zb = (x @ p["dense"][i]["w"] + p["dense"][i]["b"].unsqueeze(-2)
                  for x, p in ((xa, pa), (xb, pb)))
        flips.append(int(((za > 0).cpu() != (zb > 0).cpu()).sum()))
        xa, xb = (torch.relu(z) for z in (za, zb))
        xa, xb = ((h - h.mean(-2, keepdim=True))
                  * torch.rsqrt(h.var(-2, correction=0, keepdim=True)
                                + tcfg.bn_eps)
                  * p["bn"][i]["scale"].unsqueeze(-2)
                  + p["bn"][i]["bias"].unsqueeze(-2)
                  for h, p in ((xa, pa), (xb, pb)))
    return flips


def train_step_check(cfg, dt: str, batch, dev) -> dict:
    """One training step (method 'default', dropout 0, matmul_dtype dt)
    on the card and the same step on the CPU, from the same seeded model
    and batch: the loss, the new BN statistics, the gradients, the Adam
    moments and Δparams of the card held to the CPU's (TRAIN_LIMITS)."""
    import torch

    from mamimo_tpu_torch.config import TrainConfig
    from mamimo_tpu_torch.models.mlp import preprocess_input, tree_leaves, \
        tree_map
    from mamimo_tpu_torch.train.loop import make_batch_update, make_optimizer

    tcfg = TrainConfig(matmul_dtype=dt, method="default", dropout=0.0,
                       batch_size=batch[0].shape[1])
    cast = ((lambda t: t.to(torch.bfloat16)) if dt == "bf16"  # noqa: E731
            else (lambda t: t))
    run = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        params, bn = make_model(cfg, tcfg, seed=40, device=d)
        p0 = tree_map(torch.clone, params)
        opt = make_optimizer(tcfg)
        st = opt.init(params)
        update, _ = make_batch_update(cfg, tcfg, 1.0, opt)
        x2, pilot, y2 = (t.to(d) for t in batch)
        _, _, grads = update.loss_and_grads(params, bn, cast(x2), cast(pilot),
                                            y2, None)
        params, bn, st, loss = update(params, bn, st, x2, pilot, y2, None,
                                      tcfg.lr)
        run[where] = {
            "p0": p0, "x": preprocess_input(cfg, tcfg, cast(x2),
                                            cast(torch.stack([pilot, pilot]))),
            "loss": loss, "bn": tree_leaves(bn), "grads": tree_leaves(grads),
            "moments": tree_leaves(st.mu) + tree_leaves(st.nu),
            "delta": torch.cat([(p - q).flatten().cpu() for p, q in
                                zip(tree_leaves(params), tree_leaves(p0))])}
    c, r = run["card"], run["cpu"]
    got = {"loss": rel_err(c["loss"], r["loss"]),
           "bn": max(rel_err(a, b) for a, b in zip(c["bn"], r["bn"])),
           "grads_db": max(nmse_db(to_np(a), to_np(b))
                           for a, b in zip(c["grads"], r["grads"])),
           "moments_db": max(nmse_db(to_np(a), to_np(b))
                             for a, b in zip(c["moments"], r["moments"])),
           "delta_db": nmse_db(to_np(c["delta"]), to_np(r["delta"]))}
    flips = None                 # the float32 forward's, so f32 steps only
    if dt == "f32":
        with torch.no_grad():
            flips = relu_flips(tcfg, c["p0"], r["p0"], c["x"], r["x"])
    lim = TRAIN_LIMITS[dt]
    print(f"  {dt} step, card vs CPU (bs {tcfg.batch_size}): loss "
          f"{to_np(c['loss'])} vs {to_np(r['loss'])}, rel "
          f"{got['loss']:.3e} (limit {lim['loss']}); BN rel {got['bn']:.3e} "
          f"({lim['bn']}); grads worst leaf {got['grads_db']:.2f} dB "
          f"({lim['grads_db']}); Adam moments worst leaf "
          f"{got['moments_db']:.2f} dB ({lim['moments_db']}); Δparams "
          f"{got['delta_db']:.2f} dB ({lim['delta_db']})"
          + (f"; ReLU pre-activations of another sign, per hidden layer: "
             f"{flips} of {2 * tcfg.batch_size * tcfg.hidden[0]}"
             if flips is not None else ""))
    for k, v in got.items():
        if not v <= lim[k]:
            raise AssertionError(f"{dt} training step, card vs CPU: {k} "
                                 f"{v} > {lim[k]}")
    return {**{k: finite(v) for k, v in got.items()}, "relu_flips": flips}


def train_bound_ms(cfg, tcfg) -> tuple:
    """The least time of one training step on the card: the bytes it must
    move (the batch gathered from the complex dataset, params, both Adam
    moments and BN state each read once and written once) at 3.35 TB/s,
    and its operations (3 x the forward's) at the bf16 tensor-core peak,
    or for f32 at the float32 peak without tensor cores."""
    from mamimo_tpu_torch.bench import train_flops
    from mamimo_tpu_torch.models.mlp import model_input_spec

    _, in_dim = model_input_spec(cfg, tcfg)
    dims = (in_dim,) + tuple(tcfg.hidden) + (cfg.num_carriers,)
    n_par = 2 * sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    n_bn = 2 * 2 * sum(tcfg.hidden)               # scale, bias per plane
    n_stat = n_bn                                  # running mean, var
    mu_bytes = 2 if tcfg.opt_dtype == "bf16" else 4
    bs = tcfg.batch_size
    nbytes = (2 * (n_par + n_bn) * (4 + mu_bytes + 4) + 2 * n_stat * 4
              + bs * (cfg.len_ltf + cfg.num_carriers) * 8
              + bs * cfg.num_tx * 4)
    peak = BF16_FLOPS if tcfg.matmul_dtype == "bf16" else FP32_FLOPS
    return bound_ms(nbytes, train_flops(cfg, tcfg), peak) + (nbytes,)


def train_phase(cfg, dev, counted) -> dict:
    """Phase 5g: the training step at the width of cfg on the card, with a
    seeded model and a seeded TRAIN_PACKETS-packet device dataset: one f32
    and one bf16 step held to the CPU's (train_step_check); 32 steps on
    one fixed batch, AWGN off, whose loss must fall (the port's kernel
    launch counts read around them: the step reaches none); one
    train_step.multi of the default configuration, finite; and
    run_train_bench at 2 calls, a row for every default variant. Returns
    the results and, under "data", the dataset."""
    import torch

    from mamimo_tpu_torch.bench import (
        run_train_bench,
        train_bench_data,
        train_bench_setup,
    )
    from mamimo_tpu_torch.config import TrainConfig
    from mamimo_tpu_torch.train.loop import _gather_batch

    t0 = time.perf_counter()
    data = train_bench_data(cfg, TRAIN_PACKETS, dev)
    n_samples = TRAIN_PACKETS * cfg.num_tx * cfg.num_rx
    gi = torch.Generator(device=dev).manual_seed(41)
    idx = torch.randint(0, n_samples, (TRAIN_BS,), generator=gi, device=dev)
    batch = _gather_batch(cfg, data, idx)
    print(f"[5g train] Nt {cfg.num_tx}, Nr {cfg.num_rx}, {TRAIN_PACKETS}-"
          f"packet seeded device dataset, batch x2 {tuple(batch[0].shape)}")
    step_db = {dt: train_step_check(cfg, dt, batch, dev)
               for dt in ("f32", "bf16")}

    # 32 steps on one fixed batch, AWGN off: the loss falls
    tc = TrainConfig(method="default", dropout=0.0, batch_size=TRAIN_BS)
    state, step, _ = train_bench_setup(cfg, tc, data)
    losses = []

    def fixed_batch_steps():
        for _ in range(32):
            out = step(*state, idx, None, tc.lr)
            state[:] = out[:3]
            losses.append(float(out[3].sum()))

    _, launches = counted(fixed_batch_steps)
    print(f"  32 steps on one batch (f32, no AWGN, dropout 0): summed loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f} (every 8th: "
          + ", ".join(f"{v:.5f}" for v in losses[::8]) + ")")
    print(f"  launches of the port's kernels in those steps (the training "
          f"step reaches no TPU kernel): {launches}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the loss did not fall: {losses}")

    # the default configuration: rbg_clt AWGN, dropout 0.15, default_snr
    tc = TrainConfig(steps_per_call=4)
    state, step, mk_args = train_bench_setup(cfg, tc, data)
    *_, loss = step.multi(*state, *mk_args(42), tc.lr)
    print(f"  train_step.multi, default config ({tc.awgn_rng}, dropout "
          f"{tc.dropout}, {tc.method}), 4 steps of {tc.batch_size}: "
          f"per-plane loss {to_np(loss)}")
    if tuple(loss.shape) != (2,) or not bool(torch.isfinite(loss).all()):
        raise AssertionError(f"default-config multi step gave {loss}")
    del state, step

    short = run_train_bench(calls=2, print_result=False)
    paths = short["extra"]["paths"]
    want = {f"{v}_bs{b}" for v in ("f32", "bf16", "f32_rbg")
            for b in (256, 1024)}
    print(f"  run_train_bench(2 calls of 16 steps): {len(paths)} rows, value "
          f"{short['value']:.6g} TFLOP/s, device {short['extra']['device']}")
    if set(paths) != want or not all(r["step_ms"] > 0
                                     for r in paths.values()):
        raise AssertionError(f"run_train_bench gave {sorted(paths)}")
    print(f"  phase 5g: {time.perf_counter() - t0:.1f} s")
    return {"data": data, "step_vs_cpu": step_db, "limits": TRAIN_LIMITS,
            "fixed_batch_losses": losses[::4], "launches": launches,
            "default_config_loss": to_np(loss).tolist(),
            "bench_short": short}


def train_timing(cfg, data, smi) -> dict:
    """Phase 6, the training step: run_train_bench's line (10 calls of 16
    steps a row, the host clock closed by a loss fetch), then for each row
    one .multi call traced (every kernel's own device time, the kernels
    and aten operator calls per step) beside its host time (median of 5),
    its device-idle share, its peak device memory above what was live
    before it, and the step's bound (train_bound_ms). Returns the rows by
    name."""
    import torch

    from mamimo_tpu_torch.bench import (
        run_train_bench,
        train_bench_setup,
        train_flops,
        train_variant_config,
    )

    t0 = time.perf_counter()
    line = run_train_bench(print_result=False)
    rows = {}
    for prec in ("f32", "bf16", "f32_rbg"):
        for bs in (256, 1024):
            tc = train_variant_config(prec, bs, 16)
            state, step, mk_args = train_bench_setup(cfg, tc, data)
            idx2, gen = mk_args(1)

            def one_call():
                state[:] = step.multi(*state, idx2, gen, tc.lr)[:3]

            one_call()
            torch.cuda.synchronize()
            live = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            one_call()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - live
            host = host_ms(one_call, iters=1, batches=5, warmup=1)
            per, kernels, aten = trace_call(one_call)
            busy = sum(per.values()) if per else None
            bms, by, nbytes = train_bound_ms(cfg, tc)
            r = dict(line["extra"]["paths"][f"{prec}_bs{bs}"])
            r.update(call_host_ms=host, call_busy_ms=busy,
                     idle_share=(1 - busy / host) if busy else None,
                     bound_ms=bms, bound_by=by, bound_bytes=nbytes,
                     flops=train_flops(cfg, tc),
                     kernels_per_step=kernels / tc.steps_per_call,
                     aten_ops_per_step=aten / tc.steps_per_call,
                     peak_above_live_bytes=peak, live_bytes=live)
            rows[f"{prec}_bs{bs}"] = r
            top = sorted(((v, n) for n, v in per.items()), reverse=True)[:3]
            print(f"  train {prec} bs {bs}: {r['step_ms']:.4f} ms/step, "
                  f"{r['steps_per_s']:.1f} steps/s, "
                  f"{r['samples_per_s']:.0f} samples/s, "
                  f"{r['achieved_tflops']:.2f} TFLOP/s; bound {bms:.4f} ms by "
                  f"{by} ({bms / r['step_ms'] * 100:.1f}% of it); one .multi "
                  f"call of 16 steps: host {host:.3f} ms, traced busy "
                  + (f"{busy:.3f} ms, idle {(1 - busy / host) * 100:.1f}%"
                     if busy else "not traced")
                  + f"; per step {r['kernels_per_step']:.1f} kernels, "
                  f"{r['aten_ops_per_step']:.1f} aten calls; peak memory "
                  f"{peak / 2**30:.3f} GiB above the {live / 2**30:.3f} GiB "
                  f"live (model, optimizer state, dataset and earlier "
                  f"phases') (largest: "
                  + ", ".join(f"{n[:50]} {v:.3f}" for v, n in top)
                  + f")  [{smi}]")
            del state, step
    print(f"  training timing: {time.perf_counter() - t0:.1f} s")
    return rows


def lmmse_f64(num_carriers: int, h, tau, snr_db):
    """The LMMSE estimate M·h = Rf·(Rf + I/snr)⁻¹·h in float64 numpy (the
    reference's LMMSE_ce.m with its delays-as-h rms-delay proxy): h (B, C,
    s, R), tau (B, ns), snr_db (B, R) → (B, C, s, R) complex128."""
    tau = np.asarray(tau, np.float64)
    k = np.arange(tau.shape[-1])
    w = tau * tau
    hh = w.sum(-1)
    r = (w * k).sum(-1) / hh
    r2 = (w * k * k).sum(-1) / hh
    trms = np.sqrt(np.maximum(r2 - r * r, 0.0))
    a = np.arange(num_carriers)
    rf = 1.0 / (1.0 + 1j * 2 * np.pi * trms[:, None, None] / num_carriers
                * (a[:, None] - a[None, :]))                   # (B, C, C)
    sig2 = 10.0 ** (-np.asarray(snr_db, np.float64) / 10.0)   # (B, R)
    rpp = rf[:, None] + sig2[:, :, None, None] * np.eye(num_carriers)
    x = np.linalg.solve(rpp, np.moveaxis(np.asarray(h, np.complex128), -1, 1))
    return np.moveaxis(rf[:, None] @ x, 1, -1)


def sounding_phase(cfg, dev, counted, require_launched, pred) -> dict:
    """Phase 5h: the sounding path at the width of cfg on the card: (a)
    the OFDM round trip; (b) the LS forms on SOUND_PACKETS sounded
    packets, and kernel 4 on the same rx; (c) every LMMSE form against a
    float64 solve; (d) generate_dataset (GEN_PACKETS, chunk GEN_CHUNK, 10
    dB, CG labels): finite, its SNR, LMMSE below LS, the same at half the
    chunk, packet regeneration, the CPU port from the same draws and from
    the same realization, a synchronous fetch; (e) the nf and sinr
    receivers and the two CDL models against the CPU; (f) the corpus's
    planes through estimate_full, counted; (g) run_gen_bench, short.
    Returns the numbers."""
    import torch

    from mamimo_tpu_torch.bench import run_gen_bench
    from mamimo_tpu_torch.channel.scattering import make_scenario
    from mamimo_tpu_torch.ops.estimate import (
        lmmse_estimate,
        lmmse_estimate_cg,
        lmmse_estimate_chunked,
        lmmse_estimate_direct,
        lmmse_estimate_eig,
        ls_estimate,
        ls_estimate_matmul,
        ls_estimate_rxmajor,
    )
    from mamimo_tpu_torch.ops.kernels.fused_ls import (
        ls_estimate_pallas,
        ls_sm90_constants,
    )
    from mamimo_tpu_torch.ops.ofdm import ofdm_demodulate, ofdm_modulate
    from mamimo_tpu_torch.pipeline.dataset import (
        generate_dataset,
        packet_generator,
        scenario_generator,
    )
    from mamimo_tpu_torch.pipeline.sounding import (
        channel_from_draws,
        draw_sounding,
        sound_from_draws,
        sound_realization,
    )
    from mamimo_tpu_torch.utils.numerics import fetch_tree

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    nt, nr, C = cfg.num_tx, cfg.num_rx, cfg.num_carriers
    g = torch.Generator(device=dev).manual_seed(51)
    out = {}

    def crandn(*shape):
        return torch.complex(torch.randn(shape, generator=g, device=dev),
                             torch.randn(shape, generator=g, device=dev))

    def rel(a, b):
        a, b = (np.asarray(to_np(x) if hasattr(x, "detach") else x,
                           np.complex128) for x in (a, b))
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def on(tree, d):
        return type(tree)(*(None if t is None else t.to(d) for t in tree))

    # (a) OFDM round trip
    data = crandn(SOUND_PACKETS, C, nt, nr)
    sig = ofdm_modulate(cfg, data)
    back, _ = ofdm_demodulate(cfg, sig)
    out["ofdm_round_trip_rel"] = rel(back, data)
    print(f"[5h sounding] OFDM round trip {tuple(data.shape)} -> "
          f"{tuple(sig.shape)} -> back: rel err "
          f"{out['ofdm_round_trip_rel']:.3e} (limit 1e-6)")
    if not out["ofdm_round_trip_rel"] <= 1e-6:
        raise AssertionError(f"OFDM round trip: {out['ofdm_round_trip_rel']}")

    # (b) the LS forms on sounded packets
    scen = make_scenario(cfg, scenario_generator(GEN_SEED, dev))
    draws = draw_sounding(cfg, [packet_generator(GEN_SEED, p, dev)
                                for p in range(SOUND_PACKETS)])
    res, chan = sound_from_draws(cfg, scen, draws, 10.0)
    rx = res.rx
    grid, _ = ofdm_demodulate(cfg, rx, nsym=nt)
    h_fft = ls_estimate(cfg, grid)
    out["ls"] = {
        "matmul": check("ls_estimate(ofdm_demodulate(rx)) vs "
                        "ls_estimate_matmul", h_fft,
                        ls_estimate_matmul(cfg, rx), -100.0),
        "rxmajor": check("ls_estimate(ofdm_demodulate(rx)) vs "
                         "ls_estimate_rxmajor", h_fft, ls_estimate_rxmajor(
                             cfg, rx.transpose(1, 2).contiguous())
                         .permute(0, 3, 2, 1), -100.0),
        "ls_pair_kernel": check(
            "ls_estimate(ofdm_demodulate(rx)) vs ls_estimate_pallas "
            "(kernel 4)", h_fft, ls_estimate_pallas(
                cfg, rx, consts=ls_sm90_constants(cfg, dev, torch.float32)),
            -50.0)}

    # (c) every LMMSE form against a float64 solve, unit-scale h on the
    # sounded packets' delays
    h = crandn(SOUND_PACKETS, C, nt, nr)
    tau = res.tau
    forms = {"dense": lmmse_estimate, "direct": lmmse_estimate_direct,
             "eig": lmmse_estimate_eig,
             "chunked": lambda *a: lmmse_estimate_chunked(*a, chunk=32),
             "cg": lmmse_estimate_cg}
    out["lmmse"] = {}
    for snr in (-10.0, 0.0, 20.0):
        s = torch.full((SOUND_PACKETS, nr), snr, device=dev)
        ref = lmmse_f64(C, to_np(h), to_np(tau), to_np(s))
        scale = np.abs(ref).max()
        for name, fn in forms.items():
            err = float(np.abs(to_np(fn(cfg, h, tau, s)) - ref).max())
            lim = 2e-3 if name == "cg" else 2e-4 * scale
            out["lmmse"][f"{name} {snr:g} dB"] = err
            print(f"  lmmse {name} at {snr:g} dB vs float64 solve: max|err| "
                  f"{err:.3e} (limit {lim:.3e}; max|ref| {scale:.3f})")
            if not err <= lim:
                raise AssertionError(f"lmmse {name} at {snr} dB: {err}")
    for snr, lim in ((30.0, 2e-3), (40.0, 8e-3), (120.0, 3e-3)):
        s = torch.full((SOUND_PACKETS, nr), snr, device=dev)
        err = float((lmmse_estimate_cg(cfg, h, tau, s)
                     - lmmse_estimate_direct(cfg, h, tau, s)).abs().max())
        out["lmmse"][f"cg vs direct {snr:g} dB"] = err
        print(f"  lmmse cg vs direct at {snr:g} dB: max|err| {err:.3e} "
              f"(limit {lim})")
        if not err <= lim:
            raise AssertionError(f"lmmse cg at {snr} dB: {err}")

    # (d) generate_dataset on the card
    kw = dict(with_mmse=True, device=dev)
    ds = generate_dataset(cfg, GEN_SEED, GEN_PACKETS, 10.0, chunk=GEN_CHUNK,
                          **kw)
    arrays = ("rx", "h_ls", "h_perfect", "h_mmse", "snr_cs", "noise_db",
              "tau", "chan_delay")
    bad = [f for f in arrays if not np.isfinite(getattr(ds, f)).all()]
    ls_db = nmse_db(ds.h_ls, ds.h_perfect)
    mmse_db = nmse_db(ds.h_mmse, ds.h_perfect)
    snr_mean = float(ds.snr_cs.mean())
    out["gen"] = {"snr_cs_mean": snr_mean, "ls_nmse_db": ls_db,
                  "mmse_nmse_db": mmse_db}
    print(f"  generate_dataset({GEN_PACKETS} packets, chunk {GEN_CHUNK}, 10 "
          f"dB, CG labels) on the card: rx {ds.rx.shape}; realized SNR "
          f"{snr_mean:.3f} dB; NMSE vs h_perfect: LS {ls_db:.2f} dB, LMMSE "
          f"{mmse_db:.2f} dB; non-finite: {bad}")
    if bad or abs(snr_mean - 10.0) > 1.0 or not mmse_db < ls_db:
        raise AssertionError(f"generate_dataset: {out['gen']}, {bad}")
    half = generate_dataset(cfg, GEN_SEED, GEN_PACKETS, 10.0,
                            chunk=GEN_CHUNK // 2, **kw)
    split = draw_sounding(cfg, [packet_generator(GEN_SEED, p, dev)
                                for p in range(GEN_CHUNK // 2)])
    whole = draw_sounding(cfg, [packet_generator(GEN_SEED, p, dev)
                                for p in range(GEN_CHUNK)])
    same = all(torch.equal(a, b[:GEN_CHUNK // 2]) for a, b in
               zip(split, whole) if a is not None)
    half_db = {f: nmse_db(getattr(half, f), getattr(ds, f)) for f in arrays}
    worst = max(half_db.values())
    print(f"  chunk {GEN_CHUNK // 2} against chunk {GEN_CHUNK}: draws "
          f"{'identical' if same else 'DIFFER'}; worst array {worst:.2f} dB "
          f"(limit -100)")
    if not same or not worst <= -100.0:
        raise AssertionError(f"chunk size changed the dataset: {half_db}")
    p_re = GEN_PACKETS - 1 - GEN_PACKETS // 3
    regen, _ = sound_from_draws(
        cfg, ds.scenario, draw_sounding(cfg, [ds.packet_generator(p_re)]),
        10.0, with_mmse=True)
    re_db = max(nmse_db(to_np(getattr(regen, f)[0]), getattr(ds, f)[p_re])
                for f in arrays)
    print(f"  packet {p_re} regenerated alone by packet_generator: worst "
          f"array {re_db:.2f} dB (limit -100)")
    if not re_db <= -100.0:
        raise AssertionError(f"packet {p_re} regenerated at {re_db} dB")

    def card_vs_cpu(c, draws_c, tag, rows=None, **skw):
        """The card's sounding of draws_c against the CPU port's, from the
        same draws (2e-2 relative, the phase amplification) and from the
        card's own realization (-80 dB). rows: the card's result to hold
        (default: sounded here)."""
        scen_c = make_scenario(c, scenario_generator(GEN_SEED, dev))
        chan_c = channel_from_draws(c, scen_c, draws_c)
        if rows is None:
            rows = {f: to_np(v) for f, v in sound_realization(
                c, scen_c, chan_c, draws_c, 10.0, **skw)._asdict().items()}
        scen_h, draws_h = on(scen_c, cpu), on(draws_c, cpu)
        res_d, _ = sound_from_draws(c, scen_h, draws_h, 10.0, **skw)
        res_r = sound_realization(c, scen_h, on(chan_c, cpu), draws_h,
                                  10.0, **skw)
        r = {"same_draws_rel": {f: rel(getattr(res_d, f), rows[f])
                                for f in ("rx", "h_ls", "h_perfect",
                                          "h_mmse")},
             "same_realization_db": {f: nmse_db(to_np(getattr(res_r, f)),
                                                rows[f])
                                     for f in ("rx", "h_ls", "h_perfect",
                                               "h_mmse", "snr_cs",
                                               "noise_db")}}
        wd = max(r["same_draws_rel"].values())
        wr = max(r["same_realization_db"].values())
        r["same_realization_db"] = {k: finite(v) for k, v in
                                    r["same_realization_db"].items()}
        print(f"  {tag}: card vs CPU port, same draws worst rel {wd:.3e} "
              f"(limit 2e-2), same realization worst {wr:.2f} dB (limit "
              f"-80)")
        if not (wd <= 2e-2 and wr <= -80.0):
            raise AssertionError(f"{tag}: card vs CPU {r}")
        return r

    d4 = draw_sounding(cfg, [packet_generator(GEN_SEED, p, dev)
                             for p in range(4)])
    out["gen"]["vs_cpu"] = card_vs_cpu(
        cfg, d4, f"generate_dataset packets 0-3", with_mmse=True,
        rows={f: getattr(ds, f)[:4] for f in arrays})
    res0, _ = sound_from_draws(cfg, ds.scenario, whole, 10.0, with_mmse=True)
    sync = fetch_tree(res0)._asdict()
    sync_db = max(nmse_db(sync[f], getattr(ds, f)[:GEN_CHUNK])
                  for f in arrays)
    exact = all(np.array_equal(sync[f], getattr(ds, f)[:GEN_CHUNK])
                for f in arrays)
    out["gen"]["sync_fetch_worst_db"] = finite(sync_db)
    print(f"  chunk 0 fetched synchronously (fetch_tree) against the "
          f"overlapped fetch: "
          f"worst array {sync_db:.2f} dB (limit -100), "
          f"{'bit-identical' if exact else 'not bit-identical'}")
    if not sync_db <= -100.0:
        raise AssertionError(f"the overlapped fetch differs: {sync_db} dB")

    # (e) the other receivers and the CDL models, 8 packets each
    out["modes"] = {}
    for tag, ckw, mode in (("nf", {}, "nf"), ("sinr", {}, "sinr"),
                           ("cdl_nlos", {"channel_model": "cdl_nlos"}, "snr"),
                           ("cdl_los", {"channel_model": "cdl_los"}, "snr")):
        c = cfg.replace(**ckw)
        d8 = generate_dataset(c, GEN_SEED, 8, 10.0, noise_mode=mode, chunk=8,
                              **kw)
        bad = [f for f in arrays if not np.isfinite(getattr(d8, f)).all()]
        print(f"  generate_dataset {tag} (8 packets): realized SNR "
              f"{float(d8.snr_cs.mean()):.2f} dB, LS NMSE "
              f"{nmse_db(d8.h_ls, d8.h_perfect):.2f} dB, non-finite: {bad}")
        if bad:
            raise AssertionError(f"{tag}: non-finite {bad}")
        out["modes"][tag] = card_vs_cpu(
            c, draw_sounding(c, [packet_generator(GEN_SEED, p, dev)
                                 for p in range(8)], mode), tag,
            with_mmse=True, noise_mode=mode)

    # (f) the corpus through the serving call, counted
    planes = ds.rx_planes()
    (f_ls, _), cnt = counted(lambda: pred.estimate_full(planes))
    print(f"  estimate_full on the corpus's planes {planes.shape}")
    require_launched("estimate_full (generated corpus)", cnt,
                     ("ls_planes_v2", "factored_sig_proj", "factored_tail"))
    once = {k: cnt[k] for k in ("ls_planes_v2", "factored_sig_proj",
                                "factored_tail")}
    if set(once.values()) != {1}:
        raise AssertionError(f"estimate_full launched {once}, want 1 each")
    want_ls = ds.h_ls.transpose(0, 3, 2, 1).reshape(f_ls.shape)
    out["estimate_full_ls"] = check(
        "estimate_full LS on the corpus vs its h_ls", torch.from_numpy(f_ls),
        torch.from_numpy(want_ls), -50.0)
    out["estimate_full_launches"] = cnt

    # (g) the generation bench, short
    short = run_gen_bench(num_packets=GEN_PACKETS, chunk=GEN_CHUNK,
                          print_result=False)
    modes = short["extra"]["modes"]
    print(f"  run_gen_bench({GEN_PACKETS} packets, chunk {GEN_CHUNK}): "
          + ", ".join(f"{k} {v['packets_per_s']:.1f}" for k, v in
                      modes.items()) + " packets/s")
    if tuple(modes) != ("ls", "ls_bf16fetch", "lmmse", "with_ber",
                        "device_sounding") \
            or not all(v["packets_per_s"] > 0 for v in modes.values()):
        raise AssertionError(f"run_gen_bench gave {modes}")
    out["gen_bench_short"] = short
    print(f"  phase 5h: {time.perf_counter() - t0:.1f} s")
    return out


def sounding_timing(cfg, dev, smi, planes) -> dict:
    """Phase 6, the sounding path: run_gen_bench's line (512 packets, chunk
    64); one generate_dataset call of GEN_PACKETS in the 'ls' and 'lmmse'
    modes, host time (median of 3) beside its traced device-busy time and
    idle share; one chunk of GEN_CHUNK through sound_from_draws traced
    (its largest kernels); each LMMSE form at SOUND_PACKETS packets (CUDA
    events); the bench path ls_fft on ``planes`` (the bench shape)."""
    import torch

    from mamimo_tpu_torch.bench import _planes_to_time_major, run_gen_bench
    from mamimo_tpu_torch.channel.scattering import make_scenario
    from mamimo_tpu_torch.ops.estimate import (
        lmmse_estimate,
        lmmse_estimate_cg,
        lmmse_estimate_chunked,
        lmmse_estimate_direct,
        lmmse_estimate_eig,
    )
    from mamimo_tpu_torch.pipeline.dataset import (
        generate_dataset,
        packet_generator,
        scenario_generator,
    )
    from mamimo_tpu_torch.pipeline.sounding import (
        draw_sounding,
        estimate_from_rx,
        sound_from_draws,
    )

    t0 = time.perf_counter()
    out = {"line": run_gen_bench(print_result=False)}
    for k, v in out["line"]["extra"]["modes"].items():
        print(f"  run_gen_bench {k}: {v['packets_per_s']:.2f} packets/s "
              f"({v['estimates_per_s']:.6g} estimates/s), 512 packets in "
              f"{v['wall_s']:.4f} s  [{smi}]")
    out["calls"] = {}
    for mode, kw in (("ls", {}), ("lmmse", {"with_mmse": True})):
        fn = lambda kw=kw: generate_dataset(  # noqa: E731
            cfg, 9, GEN_PACKETS, 0.0, chunk=GEN_CHUNK, device=dev, **kw)
        host = host_ms(fn, iters=1, batches=3, warmup=1)
        per, kernels, aten = trace_call(fn)
        busy = sum(per.values()) if per else None
        top = sorted(((v, n) for n, v in per.items()), reverse=True)[:5]
        out["calls"][mode] = {"host_ms": host, "busy_ms": busy,
                              "idle_share": (1 - busy / host) if busy
                              else None, "kernels": kernels, "aten": aten,
                              "packets_per_s": GEN_PACKETS / host * 1e3,
                              "top_kernels_ms": {n: v for v, n in top}}
        print(f"  generate_dataset {mode}, {GEN_PACKETS} packets: host "
              f"{host:.3f} ms ({GEN_PACKETS / host * 1e3:.1f} packets/s), "
              f"traced busy " + (f"{busy:.3f} ms, idle "
                                 f"{(1 - busy / host) * 100:.1f}%" if busy
                                 else "not traced")
              + f"; {kernels} kernels, {aten} aten calls; largest: "
              + ", ".join(f"{n[:50]} {v:.3f}" for v, n in top)
              + f"  [{smi}]")
    scen = make_scenario(cfg, scenario_generator(GEN_SEED, dev))
    draws = draw_sounding(cfg, [packet_generator(GEN_SEED, p, dev)
                                for p in range(GEN_CHUNK)])
    for mode, kw in (("ls", {}), ("lmmse", {"with_mmse": True})):
        fn = lambda kw=kw: sound_from_draws(  # noqa: E731
            cfg, scen, draws, 0.0, **kw)
        host = host_ms(fn, iters=3, batches=3, warmup=1)
        per, kernels, aten = trace_call(fn)
        busy = sum(per.values()) if per else None
        top = sorted(((v, n) for n, v in per.items()), reverse=True)[:6]
        out["calls"][f"chunk {mode}"] = {
            "host_ms": host, "busy_ms": busy, "kernels": kernels,
            "aten": aten, "top_kernels_ms": {n: v for v, n in top}}
        print(f"  sound_from_draws, one chunk of {GEN_CHUNK} ({mode}): host "
              f"{host:.3f} ms, traced busy "
              + (f"{busy:.3f} ms" if busy else "not traced")
              + f"; {kernels} kernels, {aten} aten calls; largest: "
              + ", ".join(f"{n[:50]} {v:.4f}" for v, n in top)
              + f"  [{smi}]")
    res, _ = sound_from_draws(cfg, scen, draws, 0.0)
    g = torch.Generator(device=dev).manual_seed(52)
    h = torch.complex(*(torch.randn((GEN_CHUNK, cfg.num_carriers, cfg.num_tx,
                                     cfg.num_rx), generator=g, device=dev)
                        for _ in range(2)))
    s = torch.zeros((GEN_CHUNK, cfg.num_rx), device=dev)
    out["lmmse_ms"] = {}
    for name, fn in (("dense", lmmse_estimate), ("direct",
                                                 lmmse_estimate_direct),
                     ("eig", lmmse_estimate_eig),
                     ("chunked", lambda *a: lmmse_estimate_chunked(
                         *a, chunk=32)), ("cg", lmmse_estimate_cg)):
        ms = time_ms(lambda fn=fn: fn(cfg, h, res.tau, s), iters=3, warmup=1)
        out["lmmse_ms"][name] = ms
        print(f"  lmmse {name}, {GEN_CHUNK} packets x {cfg.num_rx} antennas "
              f"x {cfg.num_tx} streams, 0 dB: {ms:.4f} ms  [{smi}]")
    nr = cfg.num_rx
    out["ls_fft_ms"] = time_ms(lambda: estimate_from_rx(
        cfg, _planes_to_time_major(planes, nr))[0], iters=10)
    n_est = planes.shape[1] * cfg.num_tx
    print(f"  bench path ls_fft at {planes.shape[1] // nr} packets: "
          f"{out['ls_fft_ms']:.4f} ms, {n_est / out['ls_fft_ms'] * 1e3:.6g} "
          f"estimates/s  [{smi}]")
    print(f"  sounding timing: {time.perf_counter() - t0:.1f} s")
    return out


def hist_rel(a: dict, b: dict) -> float:
    """The largest relative difference of two fit histories' per-epoch
    losses (max |a - b| / max |b| per curve)."""
    worst = 0.0
    for k in ("loss_real", "loss_imag", "val_loss_real", "val_loss_imag"):
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        if x.shape != y.shape:
            return float("inf")
        worst = max(worst, float(np.abs(x - y).max() / np.abs(y).max()))
    return worst


def seed_checkpoint(workdir: str, cfg, tcfg, seed: int) -> None:
    """An epoch-0 'last' checkpoint with its optimizer state in workdir:
    weights from init_stacked on a seeded generator, Adam at count 0."""
    import os

    import torch

    from mamimo_tpu_torch.models.mlp import init_stacked
    from mamimo_tpu_torch.train.ckpt import save_checkpoint
    from mamimo_tpu_torch.train.loop import make_optimizer

    params, bn = init_stacked(torch.Generator().manual_seed(seed), cfg, tcfg)
    save_checkpoint(os.path.join(workdir, "last"), cfg, tcfg, params, bn,
                    extra={"epoch": 0},
                    opt_state=make_optimizer(tcfg).init(params))


def pipeline_phase(cfg, dev, counted, require_launched, tmp) -> dict:
    """Phase 5i: the training pipeline at the width of cfg on the card, in
    directories under tmp: (a) a PIPE_PACKETS-packet corpus at 120 dB, its
    raw container and the native loader (using_native; gather,
    gather_packets and prefetch/wait bit-equal to the NumPy plain
    version); (b) fit for 3 epochs in the in-HBM mode (steps_per_call 4)
    and the host_stream mode from one epoch-0 checkpoint (method
    'default', dropout 0, batch PIPE_BS): histories within
    PIPE_LIMITS["modes_rel"]; window streaming (PIPE_WINDOW packets),
    finite and falling; (c) with the AWGN on (rbg_clt), 2 epochs and a
    resume to 3 against 3 straight; (d) at Nt 8, Nr 2, hidden (64, 64) the
    card's fit against the CPU's from one checkpoint, the ReLU flips
    between them counted; (e) evaluate_dataset and nmse_vs_snr on a 10 dB
    corpus, finite; (f) the trained 'best' checkpoint served through
    CSIPredictor.estimate_full, one launch of each kernel; (g) the CLI's
    gen -> train -> test as subprocesses at Nt 8, hidden (64, 64), on the
    card; (h) that model's all_pairs on the card (the factored kernels on
    weights padded to 128 units) against the kernels' plain version. Returns the
    numbers and, under "keep", what phase 6 times."""
    import os
    import shutil

    import torch

    from mamimo_tpu_torch.config import SimConfig, TrainConfig
    from mamimo_tpu_torch.data.native_loader import NativeBatchLoader
    from mamimo_tpu_torch.eval.closed_loop import nmse_vs_snr
    from mamimo_tpu_torch.models.mlp import preprocess_input, tree_leaves
    from mamimo_tpu_torch.models.predictor import CSIPredictor
    from mamimo_tpu_torch.ops.kernels.fused_factored import _mm, _tail_plain
    from mamimo_tpu_torch.pipeline.dataset import generate_dataset
    from mamimo_tpu_torch.train.ckpt import load_checkpoint
    from mamimo_tpu_torch.train.loop import (
        _device_data,
        _gather_batch,
        evaluate_dataset,
        fit,
        params_from_jax,
    )

    t0 = time.perf_counter()
    out = {"limits": PIPE_LIMITS}
    cpu = torch.device("cpu")

    # (a) corpus, raw container, loader
    ds = generate_dataset(cfg, PIPE_SEED, PIPE_PACKETS, 120.0, chunk=64,
                          device=dev)
    raw = os.path.join(tmp, "corpus.raw")
    ds.save_raw(raw)
    rng = np.random.default_rng(5)
    idx = rng.integers(0, ds.num_samples, PIPE_BS)
    pkts = rng.permutation(PIPE_PACKETS)[:PIPE_WINDOW]
    with NativeBatchLoader(raw) as ld, \
            NativeBatchLoader(raw, native=False) as plain:
        if not ld.using_native:
            raise AssertionError("the native loader is not in use")
        same = {"gather": all(np.array_equal(a, b) for a, b in
                              zip(ld.gather(idx), plain.gather(idx))),
                "gather_packets": all(np.array_equal(a, b) for a, b in zip(
                    ld.gather_packets(pkts), plain.gather_packets(pkts)))}
        ld.prefetch(idx[::-1])
        same["prefetch/wait"] = all(np.array_equal(a, b) for a, b in zip(
            ld.wait(), plain.gather(idx[::-1])))
    out["loader_bit_equal"] = same
    print(f"[5i pipeline] corpus {ds.rx.shape} ({PIPE_PACKETS} packets, 120 "
          f"dB) -> raw container {os.path.getsize(raw) / 2**20:.1f} MiB; "
          f"native loader in use; bit-equal to the NumPy plain version: "
          f"{same}")
    if not all(same.values()):
        raise AssertionError(f"native loader differs from plain: {same}")

    # (b) the in-HBM and host_stream modes on the same batches; windows
    tc = TrainConfig(method="default", dropout=0.0, batch_size=PIPE_BS,
                     epochs=3, steps_per_call=4, early_stop_patience=50)
    seed_dir = os.path.join(tmp, "seed")
    seed_checkpoint(seed_dir, cfg, tc, seed=PIPE_SEED)
    runs, walls = {}, {}
    for mode, kw in (("in_hbm", {}), ("host_stream", {"host_stream": True})):
        wd = os.path.join(tmp, mode)
        shutil.copytree(seed_dir, wd)
        t1 = time.perf_counter()
        runs[mode], cnt = counted(lambda wd=wd, kw=kw: fit(
            cfg, tc, ds, workdir=wd, verbose=False, resume=True, device=dev,
            **kw))
        walls[mode] = time.perf_counter() - t1
    rel = hist_rel(runs["host_stream"].history, runs["in_hbm"].history)
    out["modes_rel"] = rel
    print(f"  fit, 3 epochs of batch {PIPE_BS} (f32, no AWGN, dropout 0) "
          f"from one checkpoint: in-HBM (steps_per_call 4) "
          f"{walls['in_hbm']:.2f} s, host_stream {walls['host_stream']:.2f} "
          f"s; val loss {np.round(runs['in_hbm'].history['val_loss_real'], 6)}"
          f"; histories differ by {rel:.3e} relative (limit "
          f"{PIPE_LIMITS['modes_rel']}); launches of the port's kernels in "
          f"the fit (the step reaches none): {cnt}")
    if not rel <= PIPE_LIMITS["modes_rel"]:
        raise AssertionError(f"in-HBM and host_stream fit differ: {rel}")
    wd = os.path.join(tmp, "window")
    t1 = time.perf_counter()
    rw = fit(cfg, tc, ds, workdir=wd, verbose=False, host_stream=True,
             stream_window_packets=PIPE_WINDOW, device=dev)
    walls["window"] = time.perf_counter() - t1
    hw = rw.history
    tr_loss = [a + b for a, b in zip(hw["loss_real"], hw["loss_imag"])]
    va_loss = [a + b for a, b in zip(hw["val_loss_real"],
                                     hw["val_loss_imag"])]
    out["window"] = {"train_loss": tr_loss, "val_loss": va_loss,
                     "wall_s": walls["window"]}
    print(f"  fit with window streaming ({PIPE_WINDOW} packets a window), 3 "
          f"epochs: {walls['window']:.2f} s; summed train loss "
          f"{np.round(tr_loss, 6)}, val {np.round(va_loss, 6)}")
    # the val loss is read in eval mode through BN running statistics that
    # 3 epochs at momentum 0.99 have barely moved: only the training loss
    # must fall
    if not (np.isfinite(tr_loss + va_loss).all()
            and tr_loss[-1] < tr_loss[0]):
        raise AssertionError(f"window streaming did not train: {hw}")
    out["fit_wall_s"] = walls

    # (c) resume with the AWGN on
    ta = TrainConfig(batch_size=PIPE_BS, epochs=3, steps_per_call=4,
                     early_stop_patience=50, seed=3)
    straight = fit(cfg, ta, ds, workdir=os.path.join(tmp, "straight"),
                   verbose=False, device=dev)
    rd = os.path.join(tmp, "resumed")
    fit(cfg, ta.replace(epochs=2), ds, workdir=rd, verbose=False, device=dev)
    resumed = fit(cfg, ta, ds, workdir=rd, verbose=False, resume=True,
                  device=dev)
    rel = hist_rel(resumed.history, straight.history)
    pv = [torch.cat([t.flatten() for t in tree_leaves(r.params)])
          for r in (resumed, straight)]
    prel = float((pv[0] - pv[1]).norm() / pv[1].norm())
    out["resume"] = {"history_rel": rel, "params_rel": prel,
                     "awgn_rng": ta.awgn_rng}
    print(f"  resume ({ta.awgn_rng} AWGN, dropout {ta.dropout}): 2 epochs + "
          f"resume to 3 vs 3 straight: histories {rel:.3e} relative, best "
          f"weights {prel:.3e} of their norm (limit "
          f"{PIPE_LIMITS['resume_rel']})")
    if not (rel <= PIPE_LIMITS["resume_rel"]
            and prel <= PIPE_LIMITS["resume_rel"]):
        raise AssertionError(f"resume differs: {rel}, {prel}")

    # (d) the card's fit against the CPU's at Nt 8, Nr 2, hidden (64, 64)
    c8 = SimConfig(num_tx=8, num_rx=2)
    t8 = TrainConfig(hidden=(64, 64), method="default", dropout=0.0,
                     batch_size=32, epochs=3, early_stop_patience=50)
    d8 = generate_dataset(c8, PIPE_SEED, 16, 120.0, chunk=16, device=dev)
    seed8 = os.path.join(tmp, "nt8_seed")
    seed_checkpoint(seed8, c8, t8, seed=PIPE_SEED)
    res8 = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        wd = os.path.join(tmp, f"nt8_{where}")
        shutil.copytree(seed8, wd)
        res8[where] = fit(c8, t8, d8, workdir=wd, verbose=False,
                          resume=True, device=d)
    rel = hist_rel(res8["card"].history, res8["cpu"].history)
    ck = load_checkpoint(os.path.join(seed8, "last"))
    idx8 = torch.arange(t8.batch_size)
    flips = {}
    for when, pair in (("start", None), ("end", (res8["card"].params,
                                                 res8["cpu"].params))):
        xs, ps = [], []
        for i, d in enumerate((dev, cpu)):
            x2, pilot, _ = _gather_batch(c8, _device_data(d8, d),
                                         idx8.to(d))
            xs.append(preprocess_input(c8, t8, x2, torch.stack([pilot,
                                                                 pilot])))
            ps.append(params_from_jax(ck["params"], ck["bn_state"], d)[0]
                      if pair is None else pair[i])
        with torch.no_grad():
            flips[when] = relu_flips(t8, ps[0], ps[1], xs[0], xs[1])
    out["card_vs_cpu"] = {"history_rel": rel, "relu_flips": flips}
    print(f"  fit at Nt 8, Nr 2, hidden (64, 64), 3 epochs of batch 32, card "
          f"vs CPU from one checkpoint: histories {rel:.3e} relative (limit "
          f"{PIPE_LIMITS['card_cpu_rel']}); ReLU pre-activations of another "
          f"sign on the first batch, per hidden layer, at the start "
          f"{flips['start']} and with the final weights {flips['end']} of "
          f"{2 * t8.batch_size * t8.hidden[0]}")
    if not rel <= PIPE_LIMITS["card_cpu_rel"]:
        raise AssertionError(f"card and CPU fit differ: {rel}")

    # (e) evaluation on a 10 dB corpus, with the in-HBM run's best weights
    ev = generate_dataset(cfg, PIPE_SEED + 1, 64, 10.0, with_mmse=True,
                          chunk=64, device=dev)
    best_dir = os.path.join(tmp, "in_hbm")
    bck = load_checkpoint(os.path.join(best_dir, "best"))
    pred, mse = evaluate_dataset(cfg, bck["tcfg"], bck["params"],
                                 bck["bn_state"], ev, device=dev)
    nm = {k: float(10 * np.log10(np.mean(v)))
          for k, v in nmse_vs_snr(ev, pred, device=dev).items()}
    out["evaluate"] = {"mse": mse.tolist(), "nmse_db": nm}
    print(f"  evaluate_dataset on 64 packets at 10 dB (3-epoch model): "
          f"per-plane MSE {mse}; nmse_vs_snr: "
          + ", ".join(f"{k} {v:.2f} dB" for k, v in nm.items()))
    if not (np.isfinite(mse).all() and np.isfinite(list(nm.values())).all()
            and np.isfinite(pred).all()):
        raise AssertionError(f"evaluation not finite: {out['evaluate']}")

    # (f) the trained checkpoint served, counted
    pred_srv = CSIPredictor(best_dir, device=dev)
    planes = ev.rx_planes()
    (h_ls, h_dnn), cnt = counted(lambda: pred_srv.estimate_full(planes))
    require_launched("estimate_full (the trained checkpoint)", cnt,
                     ("ls_planes_v2", "factored_sig_proj", "factored_tail"))
    once = {k: cnt[k] for k in ("ls_planes_v2", "factored_sig_proj",
                                "factored_tail")}
    if set(once.values()) != {1}:
        raise AssertionError(f"estimate_full launched {once}, want 1 each")
    want_dnn = pred.transpose(0, 3, 2, 1).reshape(h_dnn.shape)
    want_ls = ev.h_ls.transpose(0, 3, 2, 1).reshape(h_ls.shape)
    out["served"] = {
        "dnn_vs_evaluate": check(
            "estimate_full DNN (trained checkpoint) vs evaluate_dataset",
            torch.from_numpy(h_dnn), torch.from_numpy(want_dnn),
            PIPE_LIMITS["served_dnn_db"]),
        "ls_vs_corpus": check(
            "estimate_full LS vs the corpus's h_ls", torch.from_numpy(h_ls),
            torch.from_numpy(want_ls), PIPE_LIMITS["served_ls_db"]),
        "launches": cnt}

    # (g) the CLI on the card, as subprocesses (hidden 64: --exec-time
    # runs the factored kernels on weights padded to 128 units)
    cli = os.path.join(tmp, "cli")
    common = ["--num-tx", "8", "--num-rx", "2"]
    steps = (["gen", *common, "--packets", "16", "--snr", "120", "-o",
              f"{cli}/train.npz"],
             ["train", "-x", f"{cli}/train.npz", "-d", f"{cli}/model",
              "--nn", "64", "64", "--bs", "64", "--epochs", "2"],
             ["gen", *common, "--packets", "8", "--snr", "10", "--mmse",
              "-o", f"{cli}/test.npz"],
             ["test", "-x", f"{cli}/test.npz", "--modeldir", f"{cli}/model",
              "-d", f"{cli}/out", "--export-mat", "--exec-time"])
    t1 = time.perf_counter()
    for argv in steps:
        r = subprocess.run([sys.executable, "-m", "mamimo_tpu_torch.cli",
                            *argv], cwd=str(ROOT), capture_output=True,
                           text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"cli {argv[0]} exited {r.returncode}:\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        last = [l for l in r.stdout.splitlines() if l.startswith("[")]
        print(f"  cli {argv[0]}: exit 0; {last[-1] if last else ''}")
    with open(f"{cli}/out/test_report.json") as f:
        out["cli_report"] = json.load(f)
    print(f"  cli gen -> train -> test: {time.perf_counter() - t1:.1f} s, "
          f"test_report.json {out['cli_report']}")

    # (h) all_pairs of the CLI's hidden-64 model on the card: the factored
    # kernels on its padded weights against their plain version
    pr64 = CSIPredictor(f"{cli}/model", device=dev)
    b8 = d8.rx.shape[0]
    x8 = torch.as_tensor(d8.rx_planes(), device=dev).reshape(
        2, b8, c8.num_rx, c8.len_ltf)
    y64, cnt = counted(lambda: pr64.all_pairs_planes(x8))
    require_launched("all_pairs (hidden 64)", cnt,
                     ("factored_sig_proj", "factored_tail"))
    prep64, _ = pr64._kernel_weights()
    x16 = x8.reshape(2, -1, c8.len_ltf).to(torch.bfloat16)
    yp = _tail_plain(prep64, _mm(x16, prep64["w1"]), c8.num_carriers)
    out["all_pairs_hidden64"] = check(
        f"all_pairs, hidden {pr64.tcfg.hidden} (padded to "
        f"{prep64['w2'].shape[-1]}), vs the kernels' plain version",
        y64, torch.complex(yp[0], yp[1]).reshape(y64.shape), -40.0)
    print(f"  phase 5i: {time.perf_counter() - t0:.1f} s")
    out["keep"] = {"ds": ds, "ev": ev, "tmp": tmp}
    return out


def pipeline_timing(cfg, dev, smi, keep) -> dict:
    """Phase 6, the training pipeline, in a warm process, with a workdir
    as the CLI runs it (each epoch writes 'last' with the optimizer state,
    history.json and, on improvement, 'best'): fit's seconds per epoch and
    steps/s in each mode over 3 epochs at PIPE_PACKETS packets (host
    clock; fit fetches the losses each epoch), one epoch of each mode
    traced (device-busy ms beside its host ms, the idle share), the host
    time of one epoch's checkpoint writes, and evaluate_dataset in
    packets/s (median of 3 calls) at 4 and 32 packets a batch."""
    import os

    import torch

    from mamimo_tpu_torch.config import TrainConfig
    from mamimo_tpu_torch.train.ckpt import save_checkpoint
    from mamimo_tpu_torch.train.loop import evaluate_dataset, fit, \
        make_optimizer

    t0 = time.perf_counter()
    ds, ev, tmp = keep["ds"], keep["ev"], keep["tmp"]
    tc = TrainConfig(method="default", dropout=0.0, batch_size=PIPE_BS,
                     epochs=3, steps_per_call=4, early_stop_patience=50)
    modes = {"in_hbm": {}, "host_stream": {"host_stream": True},
             "window": {"host_stream": True,
                        "stream_window_packets": PIPE_WINDOW}}
    per_pkt = cfg.num_tx * cfg.num_rx
    n_val = int(np.floor(PIPE_PACKETS * tc.val_train_ratio))
    rows = {}
    for mode, kw in modes.items():
        wd = os.path.join(tmp, f"time_{mode}")
        one = lambda wd=wd, kw=kw: fit(  # noqa: E731
            cfg, tc.replace(epochs=1), ds, workdir=wd, verbose=False,
            device=dev, **kw)
        one()               # the raw container is written before timing
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = fit(cfg, tc, ds, workdir=wd, verbose=False, device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        steps = (PIPE_PACKETS - n_val) * per_pkt // PIPE_BS
        if mode == "window":
            n_tr = PIPE_PACKETS - n_val
            steps = sum(min(PIPE_WINDOW, n_tr - k) * per_pkt // PIPE_BS
                        for k in range(0, n_tr, PIPE_WINDOW))
        host1 = host_ms(one, iters=1, batches=1, warmup=0)
        per, kernels, aten = trace_call(one)
        busy = sum(per.values()) if per else None
        rows[mode] = {"s_per_epoch": wall / r.epochs_ran,
                      "steps_per_epoch": steps,
                      "steps_per_s": steps * r.epochs_ran / wall,
                      "epoch_host_ms": host1, "epoch_busy_ms": busy,
                      "epoch_idle_share": (1 - busy / host1) if busy
                      else None, "epoch_kernels": kernels,
                      "epoch_aten_ops": aten}
        print(f"  fit {mode}, {PIPE_PACKETS} packets, batch {PIPE_BS}: "
              f"{wall / r.epochs_ran:.4f} s/epoch, "
              f"{steps * r.epochs_ran / wall:.2f} steps/s ({steps} steps an "
              f"epoch; 3 epochs); one epoch: host {host1:.2f} ms, traced "
              f"busy " + (f"{busy:.2f} ms, idle "
                          f"{(1 - busy / host1) * 100:.1f}%" if busy
                          else "not traced")
              + f", {kernels} kernels, {aten} aten calls  [{smi}]")
    opt = make_optimizer(tc)
    ost = opt.init(r.params)
    ck_ms = host_ms(lambda: (
        save_checkpoint(os.path.join(tmp, "ck", "last"), cfg, tc, r.params,
                        r.bn_state, opt_state=ost),
        save_checkpoint(os.path.join(tmp, "ck", "best"), cfg, tc, r.params,
                        r.bn_state)), iters=1, batches=3, warmup=1)
    rows["checkpoint_writes_ms"] = ck_ms
    print(f"  one epoch's checkpoint writes ('last' with the optimizer "
          f"state, 'best'): {ck_ms:.2f} ms  [{smi}]")
    for bp in (4, 32):
        fn = lambda bp=bp: evaluate_dataset(  # noqa: E731
            cfg, tc, r.params, r.bn_state, ev, batch_packets=bp, device=dev)
        ms = host_ms(fn, iters=1, batches=3, warmup=1)
        rows[f"evaluate_dataset_bp{bp}"] = {
            "host_ms": ms, "packets_per_s": ev.num_packets / ms * 1e3}
        print(f"  evaluate_dataset, {ev.num_packets} packets, {bp} a batch: "
              f"{ms:.2f} ms, {ev.num_packets / ms * 1e3:.1f} packets/s  "
              f"[{smi}]")
    print(f"  pipeline timing: {time.perf_counter() - t0:.1f} s")
    return rows




def closed_loop_phase(cfg, dev, counted, require_launched, best_dir,
                      cli_model, tmp) -> dict:
    """Phase 5j: the closed loop at the width of cfg on the card: (a) a
    CL_PACKETS-packet corpus with LMMSE labels at each of CL_SNRS; (b)
    the DNN CSI of phase 5i's trained checkpoint (``best_dir``) through
    CSIPredictor.estimate_full, one launch of each of its kernels, held
    to evaluate_dataset; (c) evaluate_closed_loop over ls, lmmse, dnn and
    perfect: finite, at 20 dB perfect CSI decodes with a beamforming gain
    (CL_LIMITS), a table of BER, EVM, NMSE and BF gain; (d) 2 packets
    sounded on the CPU, their data legs' OMP weights on the card and on
    the CPU (the digital ones up to the SVD's phase per carrier), then the
    frame of the CPU's weights through the channel and the receiver on
    each: the decoded bits equal, EVM and SNR within CL_LIMITS; (e) generate_dataset(with_ber=True):
    the sounding bit-equal to (a)'s 20 dB corpus, the BER finite; (f)
    run_mu_snr_sweep at 2 users on MU_PACKETS packets (a placement whose
    users the array separates), ls and perfect at 30 dB: perfect CSI
    decodes every user with BER 0; (g) the CLI's sweep --closed-loop
    (with the Nt 8 model of phase 5i's CLI, ``cli_model``) and sweep
    --num-users 2 as subprocesses at Nt 8. Returns the numbers and, under
    "keep", what phase 6 times."""
    import os

    import torch

    from mamimo_tpu_torch.channel.scattering import (
        ChannelRealization,
        Scenario,
        array_positions,
        steering_vectors,
    )
    from mamimo_tpu_torch.config import default_fft_size
    from mamimo_tpu_torch.eval.closed_loop import evaluate_closed_loop
    from mamimo_tpu_torch.eval.snr_sweep import run_mu_snr_sweep
    from mamimo_tpu_torch.models.predictor import CSIPredictor
    from mamimo_tpu_torch.pipeline.dataset import (
        FIELDS,
        generate_dataset,
        scenario_generator,
    )
    from mamimo_tpu_torch.ops.omp import omp_hyb_weights
    from mamimo_tpu_torch.pipeline.datatx import (
        DataTxDraws,
        _faded,
        _map_symbols,
        _receive_and_decode,
        _transmit,
        data_tx_from_draws,
        draw_data_tx,
        steering_dictionary,
    )
    from mamimo_tpu_torch.pipeline.multiuser import make_scenarios
    from mamimo_tpu_torch.pipeline.sounding import (
        draw_sounding,
        sound_from_draws,
    )
    from mamimo_tpu_torch.train.ckpt import load_checkpoint
    from mamimo_tpu_torch.train.loop import evaluate_dataset

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    out = {"limits": CL_LIMITS}
    srcs = ("ls", "lmmse", "dnn", "perfect")

    # (a) the corpora
    dss = {snr: generate_dataset(cfg, CL_SEED, CL_PACKETS, snr,
                                 with_mmse=True, chunk=CL_PACKETS,
                                 device=dev) for snr in CL_SNRS}
    print(f"[5j closed loop] {CL_PACKETS} packets at "
          f"{', '.join(f'{s:g}' for s in CL_SNRS)} dB (LMMSE labels), "
          f"{cfg.n_rays} rays, {cfg.num_data_symbols} data symbols, "
          f"{cfg.num_frm_bits} bits a frame")

    # (b) the DNN CSI through the serving call, counted
    pred = CSIPredictor(best_dir, device=dev)
    ck = load_checkpoint(os.path.join(best_dir, "best"))
    dnn, out["served"] = {}, {}
    for snr, ds in dss.items():
        (_, h_dnn), cnt = counted(lambda ds=ds: pred.estimate_full(
            ds.rx_planes()))
        require_launched(f"estimate_full (the closed loop's DNN, {snr:g} "
                         f"dB)", cnt, ("ls_planes_v2", "factored_sig_proj",
                                       "factored_tail"))
        once = {k: cnt[k] for k in ("ls_planes_v2", "factored_sig_proj",
                                    "factored_tail")}
        if set(once.values()) != {1}:
            raise AssertionError(f"estimate_full launched {once}, want 1 "
                                 f"each")
        dnn[snr] = h_dnn.reshape(CL_PACKETS, cfg.num_rx, cfg.num_tx,
                                 cfg.num_carriers).transpose(0, 3, 2, 1)
        want, _ = evaluate_dataset(cfg, ck["tcfg"], ck["params"],
                                   ck["bn_state"], ds, device=dev)
        out["served"][snr] = {"launches": cnt, "dnn_vs_evaluate": check(
            f"closed loop's DNN CSI (estimate_full, {snr:g} dB) vs "
            f"evaluate_dataset", torch.from_numpy(dnn[snr]),
            torch.from_numpy(want), PIPE_LIMITS["served_dnn_db"])}

    # (c) the closed loop over the four sources
    out["closed_loop"] = {}
    print(f"  {'SNR':>5} {'source':>8} {'BER':>10} {'EVM %':>9} "
          f"{'NMSE dB':>9} {'BF gain dB':>11}")
    for snr, ds in dss.items():
        t1 = time.perf_counter()
        res = evaluate_closed_loop(ds, predictions=dnn[snr], sources=srcs,
                                   device=dev)
        wall = time.perf_counter() - t1
        summ = {s: res[s].summary() for s in srcs}
        out["closed_loop"][snr] = {"summary": summ, "wall_s": wall}
        for s in srcs:
            m = summ[s]
            print(f"  {snr:>5g} {s:>8} {m['ber']:>10.3e} {m['evm']:>9.3f} "
                  f"{m['nmse_db']:>9.2f} {m['bf_gain']:>11.3f}")
        print(f"  evaluate_closed_loop at {snr:g} dB: {CL_PACKETS} packets x "
              f"{len(srcs)} sources in {wall:.2f} s")
        bad = [s for s in srcs for k in ("ber", "evm", "bf_gain")
               if not np.isfinite(getattr(res[s], k)).all()]
        if bad:
            raise AssertionError(f"closed loop not finite at {snr}: {bad}")
    hi = out["closed_loop"][max(CL_SNRS)]["summary"]["perfect"]
    print(f"  at {max(CL_SNRS):g} dB perfect CSI: mean BER {hi['ber']:.3e} "
          f"(limit {CL_LIMITS['perfect_ber']}), mean BF gain "
          f"{hi['bf_gain']:.3f} dB (limit {CL_LIMITS['perfect_bf_gain_db']})")
    if not (hi["ber"] < CL_LIMITS["perfect_ber"]
            and hi["bf_gain"] > CL_LIMITS["perfect_bf_gain_db"]):
        raise AssertionError(f"perfect CSI at {max(CL_SNRS)} dB: {hi}")

    # (d) the card against the CPU on 2 packets sounded on the CPU from
    # CPU generators (LS and perfect CSI): the OMP weights on each device,
    # then the frame of the CPU's weights through the channel and the
    # receiver on each. The SVD's per-carrier phase (LAPACK's on the CPU,
    # cuSOLVER's on the card) is arbitrary, and it shapes the time-domain
    # frame, so it moves EVM and SNR at the percent level: the weights
    # are compared up to it, the rest of the leg on the same weights
    ns = cfg.num_sts
    ds = dss[max(CL_SNRS)]
    scen_c = Scenario(*(t.to(cpu) for t in ds.scenario))
    gens = [torch.Generator().manual_seed(CL_SEED * 100 + p) for p in (0, 1)]
    res_c, chan_c = sound_from_draws(cfg, scen_c, draw_sounding(cfg, gens),
                                     max(CL_SNRS))
    chan_c = ChannelRealization(*(t[:, None] for t in chan_c))
    dr_c = DataTxDraws(*(t[:, None] for t in draw_data_tx(
        cfg, [torch.Generator().manual_seed(CL_SEED + p) for p in (0, 1)])))
    csi_c = torch.stack([res_c.h_ls, res_c.h_perfect], dim=1)
    wts = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        at = steering_dictionary(cfg, dr_c.az.to(d), dr_c.el.to(d))
        wts[where] = [t.cpu() for t in omp_hyb_weights(csi_c.to(d), ns, ns,
                                                        at)]
    (fbb_g, frf_g), (fbb_c, frf_c) = wts["card"], wts["cpu"]
    inner = (fbb_g.conj() * fbb_c).sum(-1, keepdim=True)
    aligned = fbb_g * inner / inner.abs().clamp(min=1e-30)
    w_rel = {"frf": float((frf_g - frf_c).norm() / frf_c.norm()),
             "fbb_up_to_phase": float((aligned - fbb_c).norm()
                                      / fbb_c.norm())}
    legs = {}
    for where, d in (("card", dev), ("cpu", cpu)):
        bits = dr_c.bits.to(d)
        ch = ChannelRealization(*(t.to(d) for t in chan_c))
        sig = _transmit(cfg, _map_symbols(cfg, bits, ns), fbb_c.to(d),
                        frf_c.mean(-3).to(d))
        legs[where] = _receive_and_decode(
            cfg, dr_c.noise.to(d),
            _faded(cfg, sig, ch, default_fft_size(cfg, data_leg=True)),
            gain_db=scen_c.sp_loss_db.to(d),
            noise_db=res_c.noise_db.to(d)[:, None],
            chan_delay=ch.chan_delay, n_pre_sym=ns,
            own=torch.arange(ns, device=d), bits=bits,
            snr_cs=res_c.snr_cs.to(d)[:, None])
    # the card's leg on its own weights: their other phases move EVM
    own = data_tx_from_draws(
        cfg, Scenario(*(t.to(dev) for t in scen_c)),
        ChannelRealization(*(t.to(dev) for t in chan_c)), csi_c.to(dev),
        res_c.noise_db.to(dev)[:, None], res_c.snr_cs.to(dev)[:, None],
        DataTxDraws(*(t.to(dev) for t in dr_c)))
    a, b = legs["card"], legs["cpu"]
    own_evm = float(((own.evm.cpu() - b.evm).abs() / b.evm).max())
    own_snr = float((own.snr_dt.cpu() - b.snr_dt).abs().max())
    own_bits = bool(torch.equal(own.decoded.cpu(), b.decoded))
    bits_eq = bool(torch.equal(a.decoded.cpu(), b.decoded))
    evm_rel = float(((a.evm.cpu() - b.evm).abs() / b.evm).max())
    snr_diff = float((a.snr_dt.cpu() - b.snr_dt).abs().max())
    out["card_vs_cpu"] = {"weights_rel": w_rel, "bits_equal": bits_eq,
                          "evm_rel": evm_rel, "snr_dt_db": snr_diff,
                          "ber_card": a.ber.cpu().tolist(),
                          "ber_cpu": b.ber.tolist(),
                          "evm_cpu": b.evm.tolist(),
                          "own_weights": {"evm_rel": own_evm,
                                          "snr_dt_db": own_snr,
                                          "bits_equal": own_bits}}
    print(f"  2 packets sounded on the CPU, x (ls, perfect), card vs CPU: "
          f"OMP weights frf {w_rel['frf']:.3e}, fbb up to a phase per "
          f"carrier {w_rel['fbb_up_to_phase']:.3e} relative (limit "
          f"{CL_LIMITS['weights_rel']}); the data leg on the same weights: "
          f"decoded bits equal {bits_eq}, EVM {evm_rel:.3e} relative (limit "
          f"{CL_LIMITS['evm_rel']}), SNR {snr_diff:.3e} dB (limit "
          f"{CL_LIMITS['snr_db']}); BER {a.ber.cpu().tolist()}, EVM "
          f"{np.round(b.evm.numpy(), 4).tolist()} %; on the card's own "
          f"weights (cuSOLVER's phases): EVM {own_evm:.3e} relative, SNR "
          f"{own_snr:.3e} dB from the CPU's, decoded bits equal {own_bits}")
    if not (bits_eq and evm_rel <= CL_LIMITS["evm_rel"]
            and snr_diff <= CL_LIMITS["snr_db"]
            and max(w_rel.values()) <= CL_LIMITS["weights_rel"]):
        raise AssertionError(f"card and CPU data legs differ: "
                             f"{out['card_vs_cpu']}")

    # (e) generate_dataset with the data leg
    t1 = time.perf_counter()
    wb = generate_dataset(cfg, CL_SEED, CL_PACKETS, max(CL_SNRS),
                          with_mmse=True, chunk=CL_PACKETS, with_ber=True,
                          device=dev)
    same = {f: bool(np.array_equal(getattr(wb, f), getattr(ds, f)))
            for f in FIELDS}
    out["with_ber"] = {"sounding_bit_equal": same,
                       "mean_ber": float(np.mean(wb.ber)),
                       "wall_s": time.perf_counter() - t1}
    print(f"  generate_dataset(with_ber=True), {CL_PACKETS} packets at "
          f"{max(CL_SNRS):g} dB: {time.perf_counter() - t1:.2f} s, mean LS "
          f"BER {np.mean(wb.ber):.3e}; sounding bit-equal to the corpus "
          f"without it: {all(same.values())}")
    if not (all(same.values()) and np.isfinite(wb.ber).all()):
        raise AssertionError(f"with_ber: {out['with_ber']}")

    # (f) the multi-user sweep on a placement the array separates: the
    # first seed whose two users' steering vectors are < 0.3 correlated
    mu = cfg.replace(num_users=2)
    pos = array_positions(mu.num_tx, mu.tx_geometry, 0.5, mu.num_sts)
    for mu_seed in range(100):
        sc = make_scenarios(mu, scenario_generator(mu_seed, dev))
        av = steering_vectors(pos, sc.mobile_az[:, None], sc.mobile_el[:, None])
        corr = float((av[0, :, 0].conj() @ av[1, :, 0]).abs() / mu.num_tx)
        if corr < 0.3:
            break
    t1 = time.perf_counter()
    mres = run_mu_snr_sweep(mu, [30.0], MU_PACKETS, seed=mu_seed,
                            sources=("ls", "perfect"), verbose=False,
                            device=dev)
    per = mres["sources"]["perfect"]["ber"][0]
    out["multi_user"] = {"seed": mu_seed, "steering_corr": corr,
                         "result": mres,
                         "wall_s": time.perf_counter() - t1}
    print(f"  run_mu_snr_sweep, 2 users (seed {mu_seed}, steering "
          f"correlation {corr:.3f}), {MU_PACKETS} packets at 30 dB: "
          f"{time.perf_counter() - t1:.2f} s; BER per user: perfect {per}, "
          f"ls {mres['sources']['ls']['ber'][0]}; EVM perfect "
          f"{np.round(mres['sources']['perfect']['evm'][0], 3).tolist()}")
    if any(v != 0.0 for v in per):
        raise AssertionError(f"multi-user perfect CSI at 30 dB: BER {per}")

    # (g) the CLI's sweeps on the card, as subprocesses at Nt 8
    cl_dir = os.path.join(tmp, "cl_cli")
    common = ["--num-tx", "8", "--num-rx", "2"]
    t1 = time.perf_counter()
    for argv, result in (
            (["sweep", *common, "--snr", "0", "10", "--packets", "8",
              "--closed-loop", "--cl-packets", "8", "--modeldir", cli_model,
              "-o", f"{cl_dir}/su"], f"{cl_dir}/su/sweep.json"),
            (["sweep", *common, "--num-users", "2", "--snr", "10",
              "--packets", "4", "-o", f"{cl_dir}/mu"],
             f"{cl_dir}/mu/mu_sweep.json")):
        r = subprocess.run([sys.executable, "-m", "mamimo_tpu_torch.cli",
                            *argv], cwd=str(ROOT), capture_output=True,
                           text=True, timeout=300)
        if r.returncode != 0:
            raise AssertionError(f"cli {argv[:2]} exited {r.returncode}:\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        with open(result) as f:
            out[f"cli_{os.path.basename(result)}"] = json.load(f)
        print(f"  cli {argv[0]} "
              f"{'--num-users 2' if '--num-users' in argv else '--closed-loop'}"
              f": exit 0, "
              f"{os.path.basename(result)} written")
    su = out["cli_sweep.json"]
    print(f"  cli sweeps: {time.perf_counter() - t1:.1f} s; --closed-loop "
          f"BER {su['ber']}")
    print(f"  phase 5j: {time.perf_counter() - t0:.1f} s")
    out["keep"] = {"ds": ds, "dnn": dnn[max(CL_SNRS)]}
    return out


def closed_loop_timing(cfg, dev, smi, keep, gen_line) -> dict:
    """Phase 6, the closed loop: one chunk of evaluate_closed_loop
    (CL_PACKETS packets x 4 sources, closed_loop_chunk) on the host clock
    (median of 3) beside its traced device-busy time, idle share, kernels
    and aten calls; the host time of its parts on the same inputs: OMP
    with the SVD (the steering dictionary and omp_hyb_weights), the
    channel (the frame's precoding and modulation and apply_channel), the
    receiver with the Viterbi decoder, and the Viterbi loop alone at the
    chunk's shape (its time does not depend on the LLRs), traced too;
    packets x sources per second; run_gen_bench's with_ber rate (from
    ``gen_line``)."""
    import torch

    from mamimo_tpu_torch.channel.scattering import (
        ChannelRealization,
        Scenario,
    )
    from mamimo_tpu_torch.config import default_fft_size
    from mamimo_tpu_torch.eval.closed_loop import (
        closed_loop_chunk,
        eval_generator,
    )
    from mamimo_tpu_torch.ops.coding import viterbi_decode
    from mamimo_tpu_torch.ops.omp import omp_hyb_weights
    from mamimo_tpu_torch.pipeline.datatx import (
        DataTxDraws,
        _faded,
        _map_symbols,
        _receive_and_decode,
        _transmit,
        draw_data_tx,
        steering_dictionary,
    )
    from mamimo_tpu_torch.pipeline.sounding import (
        channel_from_draws,
        draw_channel,
    )

    t0 = time.perf_counter()
    ds, dnn = keep["ds"], keep["dnn"]
    csi_np = np.stack([ds.h_ls, ds.h_mmse, dnn, ds.h_perfect], axis=1)
    n_pairs = csi_np.shape[0] * csi_np.shape[1]
    pk = range(CL_PACKETS)
    chunk = lambda: closed_loop_chunk(ds, pk, csi_np, device=dev)  # noqa: E731
    host = host_ms(chunk, iters=1, batches=3, warmup=1)
    per, kernels, aten = trace_call(chunk)
    busy = sum(per.values()) if per else None
    out = {"chunk": {"host_ms": host, "busy_ms": busy,
                     "idle_share": (1 - busy / host) if busy else None,
                     "kernels": kernels, "aten": aten,
                     "packets_x_sources_per_s": n_pairs / host * 1e3}}
    print(f"  evaluate_closed_loop, one chunk of {CL_PACKETS} packets x 4 "
          f"sources: host {host:.2f} ms ({n_pairs / host * 1e3:.1f} packet-"
          f"sources/s), traced busy "
          + (f"{busy:.2f} ms, idle {(1 - busy / host) * 100:.1f}%" if busy
             else "not traced") + f"; {kernels} kernels, {aten} aten calls"
          f"  [{smi}]")

    # the parts, on the chunk's own inputs
    scen = Scenario(*(torch.as_tensor(t).to(dev) for t in ds.scenario))
    sd = draw_channel(cfg, [ds.packet_generator(p) for p in pk])
    chan = ChannelRealization(*(t[:, None] for t in channel_from_draws(
        cfg, scen, sd)))
    dr = DataTxDraws(*(t[:, None] for t in draw_data_tx(
        cfg, [eval_generator(1234, p, dev) for p in pk])))
    csi = torch.as_tensor(csi_np, device=dev)
    ns = cfg.num_sts
    fft = default_fft_size(cfg, data_leg=True)

    def omp():
        at = steering_dictionary(cfg, dr.az, dr.el)
        return omp_hyb_weights(csi, ns, ns, at)

    fbb, frf = omp()
    grid = _map_symbols(cfg, dr.bits, ns)

    def channel():
        return _faded(cfg, _transmit(cfg, grid, fbb, frf.mean(-3)), chan,
                      fft)

    faded = channel()

    def receive():
        return _receive_and_decode(
            cfg, dr.noise, faded, gain_db=scen.sp_loss_db,
            noise_db=torch.as_tensor(ds.noise_db, device=dev)[:, None],
            chan_delay=chan.chan_delay, n_pre_sym=ns,
            own=torch.arange(ns, device=dev), bits=dr.bits,
            snr_cs=torch.as_tensor(ds.snr_cs, device=dev)[:, None])

    g = torch.Generator(device=dev).manual_seed(61)
    llr = torch.randn((CL_PACKETS, 4, 3 * (cfg.num_frm_bits + 6)),
                      generator=g, device=dev)
    parts = {"omp_svd": omp, "channel": channel, "receiver": receive,
             "viterbi": lambda: viterbi_decode(llr, cfg.num_frm_bits)}
    out["parts"] = {}
    for name, fn in parts.items():
        ms = host_ms(fn, iters=1, batches=3, warmup=1)
        p2, k2, a2 = trace_call(fn)
        b2 = sum(p2.values()) if p2 else None
        out["parts"][name] = {"host_ms": ms, "busy_ms": b2, "kernels": k2,
                              "aten": a2}
        print(f"  closed-loop part {name}: host {ms:.2f} ms, traced busy "
              + (f"{b2:.2f} ms" if b2 else "not traced")
              + f", {k2} kernels, {a2} aten calls  [{smi}]")
    rest = host - sum(out["parts"][k]["host_ms"]
                      for k in ("omp_svd", "channel", "receiver"))
    vit = out["parts"]["viterbi"]["host_ms"]
    out["split_ms"] = {"omp_svd": out["parts"]["omp_svd"]["host_ms"],
                       "channel": out["parts"]["channel"]["host_ms"],
                       "viterbi": vit,
                       "receiver_without_viterbi":
                           out["parts"]["receiver"]["host_ms"] - vit,
                       "rest": rest}
    print(f"  closed-loop chunk split (host ms of {host:.2f}): "
          + ", ".join(f"{k} {v:.2f}" for k, v in out["split_ms"].items())
          + f"; the Viterbi loop {vit / host * 100:.1f}% of the chunk  "
          f"[{smi}]")
    wb = gen_line["extra"]["modes"]["with_ber"]
    out["gen_with_ber"] = wb
    print(f"  run_gen_bench with_ber: {wb['packets_per_s']:.2f} packets/s "
          f"(512 packets in {wb['wall_s']:.4f} s; ls "
          f"{gen_line['extra']['modes']['ls']['packets_per_s']:.2f})  "
          f"[{smi}]")
    print(f"  closed-loop timing: {time.perf_counter() - t0:.1f} s")
    return out


def split_relu_flips(tcfg, params, xin, n_data: int, n_model: int) -> list:
    """Per hidden layer, the pre-activations whose sign differs between
    the single-card forward and one assembled from the data x model
    split's products (layer 0 per rank's rows and columns, layer 1 as the
    sum of the model ranks' partial products; BN statistics two-pass as
    the sharded step takes them); train mode, no dropout."""
    import torch

    def bn(h, i, two_pass):
        h = torch.relu(h)
        mu = h.mean(-2, keepdim=True)
        var = (((h - mu) ** 2).mean(-2, keepdim=True) if two_pass
               else h.var(-2, correction=0, keepdim=True))
        return ((h - mu) * torch.rsqrt(var + tcfg.bn_eps)
                * params["bn"][i]["scale"].unsqueeze(-2)
                + params["bn"][i]["bias"].unsqueeze(-2))

    (w0, b0), (w1, b1) = ((l["w"], l["b"].unsqueeze(-2))
                          for l in params["dense"])
    rows, cols = xin.shape[1] // n_data, w0.shape[-1] // n_model
    z0 = xin @ w0 + b0
    z0s = torch.cat([torch.cat([
        xin[:, d * rows:(d + 1) * rows] @ w0[..., m * cols:(m + 1) * cols]
        + b0[..., m * cols:(m + 1) * cols] for m in range(n_model)], -1)
        for d in range(n_data)], 1)
    h, hs = bn(z0, 0, False), bn(z0s, 0, True)
    z1 = h @ w1 + b1
    z1s = sum(hs[..., m * cols:(m + 1) * cols] @ w1[:, m * cols:(m + 1) * cols]
              for m in range(n_model)) + b1
    return [int(((a > 0) != (b > 0)).sum()) for a, b in ((z0, z0s),
                                                         (z1, z1s))]


def sharded_step_check(cfg, axes: dict, batch, dev) -> dict:
    """One sharded step (method 'default', dropout 0) on ``axes`` of
    MESH_RANKS virtual ranks of dev against the single-card step on the
    card, from the same seeded model and batch: loss, new BN statistics,
    Adam moments (the gradients) and Δparams held to TRAIN_LIMITS["f32"];
    the ReLU pre-activations of another sign counted (split_relu_flips)."""
    import torch

    from mamimo_tpu_torch.config import TrainConfig
    from mamimo_tpu_torch.models.mlp import preprocess_input, tree_leaves, \
        tree_map
    from mamimo_tpu_torch.parallel.mesh import make_mesh
    from mamimo_tpu_torch.parallel.sharded import (
        gather_tree,
        make_sharded_train_step,
        place_state,
    )
    from mamimo_tpu_torch.train.loop import make_batch_update, make_optimizer

    tcfg = TrainConfig(method="default", dropout=0.0,
                       batch_size=batch[0].shape[1])
    x2, pilot, y2 = batch
    opt = make_optimizer(tcfg)
    params, bn = make_model(cfg, tcfg, seed=40, device=dev)
    p0 = tree_map(torch.clone, params)
    update, _ = make_batch_update(cfg, tcfg, 1.0, opt)
    params, bn, st, loss = update(params, bn, opt.init(params), x2, pilot,
                                  y2, None, tcfg.lr)
    mesh = make_mesh(axes, devices=[dev] * MESH_RANKS)
    hp, hb = make_model(cfg, tcfg, seed=40, device="cpu")
    state = place_state(mesh, hp, hb, opt.init(hp))
    _, step = make_sharded_train_step(cfg, tcfg, mesh, avg_sig_pow=1.0)
    sp, sb, ss, sloss = step(*state, x2, pilot, y2, None, tcfg.lr)
    gp, gb, gs = (gather_tree(t) for t in (sp, sb, ss))
    got = {"loss": rel_err(sloss, loss),
           "bn": max(rel_err(a, b) for a, b in
                     zip(tree_leaves(gb), tree_leaves(bn))),
           "moments_db": max(nmse_db(to_np(a), to_np(b)) for a, b in zip(
               tree_leaves(gs.mu) + tree_leaves(gs.nu),
               tree_leaves(st.mu) + tree_leaves(st.nu))),
           "delta_db": nmse_db(
               torch.cat([(a - c.cpu()).flatten() for a, c in
                          zip(tree_leaves(gp), tree_leaves(p0))]).numpy(),
               torch.cat([(b - c).flatten().cpu() for b, c in
                          zip(tree_leaves(params), tree_leaves(p0))]
                         ).numpy())}
    with torch.no_grad():
        flips = split_relu_flips(
            tcfg, p0, preprocess_input(cfg, tcfg, x2,
                                       torch.stack([pilot, pilot])),
            mesh.shape.get("data", 1), mesh.shape.get("model", 1))
    lim = TRAIN_LIMITS["f32"]
    print(f"  sharded step {axes} vs the single card (bs "
          f"{tcfg.batch_size}): loss {to_np(sloss)} vs {to_np(loss)}, rel "
          f"{got['loss']:.3e} (limit {lim['loss']}); BN rel {got['bn']:.3e} "
          f"({lim['bn']}); Adam moments worst leaf {got['moments_db']:.2f} "
          f"dB ({lim['moments_db']}); Δparams {got['delta_db']:.2f} dB "
          f"({lim['delta_db']}); ReLU pre-activations of another sign, per "
          f"hidden layer: {flips} of {2 * tcfg.batch_size * tcfg.hidden[0]}")
    for k, v in got.items():
        if not v <= lim[k]:
            raise AssertionError(f"sharded step {axes} vs the single card: "
                                 f"{k} {v} > {lim[k]}")
    return {**{k: finite(v) for k, v in got.items()}, "relu_flips": flips}


def sharded_phase(cfg, dev, counted, require_launched, data, ds) -> dict:
    """Phase 5k: the sharded training step and multi-host layer on
    MESH_RANKS virtual ranks of dev at the width of cfg: (a) one step on
    data 2 x model 2 and on data 4 against the single-card step
    (sharded_step_check), batch TRAIN_BS·4 of phase 5g's dataset; (b) a
    2-epoch fit(mesh=...) on data 2 x model 2 in the three modes on
    phase 5i's corpus, each against the single card's fit in that mode
    (MESH_LIMITS["fit_rel"]); (c) dryrun_multichip(MESH_RANKS) on the
    virtual ranks, counted: the LS kernel and the halo kernel must
    launch; (d) a hidden-64 model served through predict_complex_pallas
    (kernel 5 on weights padded to 128 units) against the kernels' plain
    version."""
    import torch

    from mamimo_tpu_torch.config import TrainConfig
    from mamimo_tpu_torch.entry import dryrun_multichip
    from mamimo_tpu_torch.models.mlp import plane, preprocess_input
    from mamimo_tpu_torch.ops.kernels.mlp_infer import (
        _layer1_plain,
        _tail_plain,
        predict_complex_pallas,
        prepare_mlp_infer_weights,
    )
    from mamimo_tpu_torch.parallel.mesh import make_mesh
    from mamimo_tpu_torch.train.loop import _gather_batch, fit
    from mamimo_tpu_torch.utils.numerics import full_f32_matmul

    t0 = time.perf_counter()
    out = {"limits": {**MESH_LIMITS, "step": TRAIN_LIMITS["f32"]}}
    n_samples = data["rx"].shape[0] * cfg.num_tx * cfg.num_rx
    gi = torch.Generator(device=dev).manual_seed(43)
    bs = 4 * TRAIN_BS
    idx = torch.randint(0, n_samples, (bs,), generator=gi, device=dev)
    batch = _gather_batch(cfg, data, idx)
    print(f"[5k sharded] {MESH_RANKS} virtual ranks of one card (cuda:0), "
          f"Nt {cfg.num_tx}, hidden (1024, 1024), batch {bs}")
    (steps, launches) = counted(lambda: {
        "data2_model2": sharded_step_check(
            cfg, {"data": 2, "model": 2}, batch, dev),
        "data4": sharded_step_check(cfg, {"data": 4}, batch, dev)})
    print(f"  launches of the port's kernels in the sharded steps (the step "
          f"reaches no TPU kernel): {launches}")
    out["step_vs_single"] = steps

    # (b) fit on the mesh in each mode against the single card's
    tc = TrainConfig(method="default", dropout=0.0, batch_size=PIPE_BS,
                     epochs=2, early_stop_patience=50)
    mesh = make_mesh({"data": 2, "model": 2}, devices=[dev] * MESH_RANKS)
    fits = {}
    for mode, kw in (("in_hbm", {}), ("host_stream", {"host_stream": True}),
                     ("window", {"host_stream": True,
                                 "stream_window_packets": PIPE_WINDOW})):
        t1 = time.perf_counter()
        r_mesh = fit(cfg, tc, ds, verbose=False, mesh=mesh, **kw)
        t_mesh = time.perf_counter() - t1
        r_one = fit(cfg, tc, ds, verbose=False, device=dev, **kw)
        rel = hist_rel(r_mesh.history, r_one.history)
        fits[mode] = {"rel": rel, "seconds": t_mesh,
                      "loss_real": r_mesh.history["loss_real"]}
        print(f"  fit(mesh=data 2 x model 2) {mode}, 2 epochs: "
              f"{t_mesh:.1f} s, loss_real {r_mesh.history['loss_real']}, "
              f"history vs the single card's rel {rel:.3e} (limit "
              f"{MESH_LIMITS['fit_rel']})")
        if not (rel <= MESH_LIMITS["fit_rel"]
                and np.isfinite(r_mesh.history["loss_real"]).all()):
            raise AssertionError(f"fit(mesh) {mode}: {fits[mode]}")
    out["fit_vs_single"] = fits

    # (c) the multi-chip dry run on the virtual ranks, counted
    dry, cnt = counted(lambda: dryrun_multichip(
        MESH_RANKS, devices=[dev] * MESH_RANKS))
    require_launched("dryrun_multichip", cnt,
                     ("ls_planes_v2", "ls_planes_v2 f32",
                      "halo_exchange_pallas"))
    out["dryrun"] = {"shapes": {k: v for k, v in dry.items()},
                     "launches": cnt}

    # (d) a hidden-64 model through kernel 5, against its plain version
    t64 = TrainConfig(hidden=(64, 64))
    params, bn = make_model(cfg, t64, seed=44, device=dev)
    with full_f32_matmul():
        prep = prepare_mlp_infer_weights(t64, params, bn)
    g = torch.Generator(device=dev).manual_seed(45)
    sig = torch.complex(*(torch.randn((256, cfg.len_ltf), generator=g,
                                      device=dev) for _ in range(2)))
    pil = torch.randint(0, 2, (256, cfg.num_tx), generator=g,
                        device=dev).float() * 2 - 1
    got, cnt64 = counted(lambda: predict_complex_pallas(cfg, t64, prep, None,
                                                        sig, pil))
    ys = [_tail_plain(plane(prep, d), _layer1_plain(
        plane(prep, d), preprocess_input(cfg, t64, part.float(), pil)))
        for d, part in enumerate((sig.real, sig.imag))]
    out["hidden64"] = check(
        "predict_complex_pallas, hidden (64, 64) padded to 128, vs the "
        "kernels' plain version", got, torch.complex(ys[0], ys[1]),
        MESH_LIMITS["hidden64_db"])
    require_launched("predict_complex_pallas (hidden 64)", cnt64,
                     ("mlp_infer_layer1", "mlp_infer_tail"))
    print(f"  phase 5k: {time.perf_counter() - t0:.1f} s")
    return out


def sharded_timing(cfg, dev, smi, data) -> dict:
    """Phase 6, the sharded step: for the single card and for data 2 x
    model 2 and data 4 on MESH_RANKS virtual ranks, one f32 step at batch
    1024 (default config, the batch gathered on the ranks from phase 5g's
    dataset): ms/step on the host clock (median of 5 batches of 5 steps),
    one step traced (device-busy ms, idle share, kernels and aten calls
    per step)."""
    import torch

    from mamimo_tpu_torch.bench import train_variant_config
    from mamimo_tpu_torch.models.mlp import init_stacked
    from mamimo_tpu_torch.parallel.mesh import make_mesh
    from mamimo_tpu_torch.parallel.sharded import (
        make_sharded_train_step,
        replicate,
    )
    from mamimo_tpu_torch.train.loop import make_optimizer, make_train_step

    tc = train_variant_config("f32", 1024, 1)
    n_samples = data["rx"].shape[0] * cfg.num_tx * cfg.num_rx
    g = torch.Generator(device=dev).manual_seed(46)
    idx = torch.randint(0, n_samples, (tc.batch_size,), generator=g,
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(47)
    rows = {}
    for name in ("single card", "data 2 x model 2", "data 4"):
        opt = make_optimizer(tc)
        if name == "single card":
            params, bn = init_stacked(torch.Generator().manual_seed(0), cfg,
                                      tc, device=dev)
            state = [params, bn, opt.init(params)]
            step = make_train_step(cfg, tc, data, 1.0, opt)[0]

            def one(step=step, state=state):
                state[:] = step(*state, idx, gen, tc.lr)[:3]
        else:
            axes = ({"data": 2, "model": 2} if "model" in name
                    else {"data": 4})
            mesh = make_mesh(axes, devices=[dev] * MESH_RANKS)
            init_fn, sh = make_sharded_train_step(cfg, tc, mesh,
                                                  avg_sig_pow=1.0)
            state = list(init_fn(torch.Generator().manual_seed(0)))
            rep = replicate(mesh, data)

            def one(sh=sh, state=state, rep=rep):
                state[:] = sh.gather(*state, rep, idx, gen, tc.lr)[:3]
        host = host_ms(one, iters=5, batches=5, warmup=2)
        per, kernels, aten = trace_call(one)
        busy = sum(per.values()) if per else None
        rows[name] = {"ms_per_step": host, "busy_ms": busy,
                      "idle_share": (1 - busy / host) if busy else None,
                      "kernels_per_step": kernels, "aten_per_step": aten}
        print(f"  train step {name} (f32, batch 1024, {tc.awgn_rng} AWGN, "
              f"dropout {tc.dropout}): {host:.4f} ms/step host, traced busy "
              + (f"{busy:.3f} ms, idle {(1 - busy / host) * 100:.1f}%"
                 if busy else "not traced")
              + f", {kernels} kernels, {aten} aten calls a step  [{smi}]")
        del state
    return rows


def planes_of_parts(cfg, z, loc):
    """The float32 planes (2, S, loc·sym_len) whose part transform
    (fused_ls.py::ls_parts) is z (2, S, loc·fft), up to float32 rounding:
    Y_v = Σ_p H_nl[v, p] Z_p / nl (H_nl H_nl = nl I) in float64, zeros in
    the cyclic prefix, which the LS never reads."""
    import torch

    from mamimo_tpu_torch.ops.ltf import _hadamard_np

    nl, fft, s = loc // 128, cfg.fft_length, z.shape[1]
    h = torch.from_numpy(_hadamard_np(nl).astype(np.float64)).to(z.device)
    y = torch.einsum("vp,aspmf->asvmf", h,
                     z.double().view(2, s, nl, 128, fft)) / nl
    x = torch.zeros((2, s, nl, 128, cfg.sym_len), device=z.device)
    x[..., cfg.cp_length:cfg.cp_length + fft] = y.float()
    return x.view(2, s, loc * cfg.sym_len)


def check_v2_modes(cfg, x16, k90, tag, seq=None):
    """ls_planes_v2's bf16 store and per-tile sums of h^2 (and the
    f32 store with sums) against the plain version on the same bf16
    planes: the estimate within -45 dB of the float32 plain version;
    the sums within 1e-4 relative per tile of the plain version's
    sums on the kernel's own constants (bf16-valued: against the
    float32 DFT the estimate differs by about -58 dB, which moves a
    tile's sums by up to about 3e-3) and, at 512 symbols a sample and
    more, on the kernel's own input, the part transform's bf16 output
    (planes_of_parts), and equal from a second call. Returns the
    results by (out_dtype, with_ssq)."""
    import torch

    from mamimo_tpu_torch.ops.estimate import (
        ls_estimate_planes,
        ls_planes_constants,
    )
    from mamimo_tpu_torch.ops.kernels.fused_ls import (
        PARTS_MIN_LOC,
        _ls_parts_plain,
        _ls_v2_plain,
        _ssq_plain,
        ls_planes_v2,
    )

    bf16, dev = torch.bfloat16, x16.device
    loc = cfg.num_tx if seq is None else cfg.num_tx // seq[1]
    x32 = x16.float()
    ref = _ls_v2_plain(cfg, x32, seq)
    at_r, at_i, pm_ = ls_planes_constants(cfg, bf16, device=dev)
    if seq is not None:
        pm_ = pm_[:, seq[0] * loc:(seq[0] + 1) * loc]
    # at PARTS_MIN_LOC symbols a sample and more the kernel reads the
    # part transform's bf16 output: the sums' reference is the LS of the
    # planes whose transform is exactly that output
    xs = planes_of_parts(cfg, _ls_parts_plain(cfg, x16, loc), loc) \
        if loc >= PARTS_MIN_LOC else x32
    hk = ls_estimate_planes(cfg, xs, (at_r, at_i, pm_))
    ssq_ref = _ssq_plain(torch.stack([hk.real, hk.imag]), loc)
    out = {}
    for dt, ws in ((bf16, True), (bf16, False), (torch.float32, True)):
        what = (f"ls_planes_v2 {tag}{'' if seq is None else f' seq {seq}'}"
                f" {str(dt)[6:]} out{' + ssq' if ws else ''}")
        got = ls_planes_v2(cfg, x16, k90, seq_shard=seq, out_dtype=dt,
                           with_ssq=ws)
        h, q = got if ws else (got, None)
        if h.dtype != dt:
            raise AssertionError(f"{what}: {h.dtype}, want {dt}")
        r = check(f"{what} vs its plain version (f32)", h, ref, -45.0)
        if ws:
            if q.shape != ssq_ref.shape or not bool(
                    torch.isfinite(q).all()):
                raise AssertionError(f"{what}: sums {tuple(q.shape)}, "
                                     f"want {tuple(ssq_ref.shape)}")
            rel = float(((q - ssq_ref).abs()
                         / ssq_ref.abs().clamp_min(1e-30)).max())
            again = ls_planes_v2(cfg, x16, k90, seq_shard=seq,
                                 out_dtype=dt, with_ssq=True)[1]
            same = bool(torch.equal(q, again))
            print(f"  {what}: sums {tuple(q.shape)}, max rel err per "
                  f"tile {rel:.3e} (limit 1e-4) vs the plain version on "
                  f"the kernel's constants; second call "
                  f"{'identical' if same else 'DIFFERS'}")
            if not (rel <= 1e-4 and same):
                raise AssertionError(f"{what}: sums off by {rel:.3e} or "
                                     f"not deterministic")
            r["ssq_max_rel_err"] = rel
        out[(dt, ws)] = r
    return out


def heads_rows_fused(prep, sp):
    """The plain version's per-head rows (_heads_plain: relu(sp + hb) in
    float32, times a1, plus c1) with the product and the sum in one
    rounding, as the kernel's FMA: exact in float64 (a float32 product
    is), then float32, then bf16; (2, S*nt, H1) bf16. (A float64 sum
    rounded twice could miss fmaf only where it lands on a float32
    midpoint, about 2^-28 of the values, and then the bf16 rounding too.)"""
    import torch

    h = torch.relu(sp[:, :, None, :] + prep["hb"][:, None, :, :])
    v = h.double() * prep["a1"][:, None].double() \
        + prep["c1"][:, None].double()
    return v.float().to(torch.bfloat16).view(2, -1, sp.shape[2])


# compute-sanitizer's own errors that say it cannot check the process here
MEMCHECK_NO_ATTACH = ("Device not supported",)


def memcheck_route(dev) -> dict:
    """The two-GEMM route at H2 % 256 = 128 under compute-sanitizer's
    memcheck (tools/memcheck_route.py, the caching allocator off), where
    the toolkit has it. The run counts as not checked only where the
    checker says that it cannot attach to this card (MEMCHECK_NO_ATTACH,
    e.g. "Device not supported"), before any access report; anything
    else fails the phase: an access report ("Invalid ...", "Program hit
    ..."), a non-zero ERROR SUMMARY or none, a non-zero exit, a time-out,
    or the script's line missing."""
    import shutil

    tool = shutil.which("compute-sanitizer") or \
        "/usr/local/cuda/bin/compute-sanitizer"
    if not Path(tool).exists():
        print("  [5l] memcheck: the toolkit has no compute-sanitizer; not run")
        return {"ran": False, "reason": "no compute-sanitizer"}
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    t0 = time.perf_counter()
    try:
        r = subprocess.run(
            [tool, "--tool", "memcheck", sys.executable,
             str(ROOT / "mamimo_tpu_torch" / "tools" / "memcheck_route.py")],
            capture_output=True, text=True, timeout=300, env=env,
            cwd=str(ROOT))
        out, rc = r.stdout + r.stderr, r.returncode
    except subprocess.TimeoutExpired as e:
        out, rc = f"timed out after {e.timeout} s", None
    secs = time.perf_counter() - t0
    lines = [ln.strip() for ln in out.splitlines()]
    checker = [ln for ln in lines if ln.startswith("=========")]
    reports = [ln for ln in checker
               if re.match(r"=+ +(Invalid |Program hit )", ln)]
    no_attach = [ln for ln in checker
                 if any(m in ln for m in MEMCHECK_NO_ATTACH)]
    if no_attach and not any(ln.startswith("========= Invalid ")
                             for ln in reports):
        # the checker's own error: a "Program hit" that follows it is
        # the failed attach breaking the CUDA runtime, not a kernel fault
        tail = " | ".join(no_attach[:2])[:400]
        print(f"  [5l] memcheck: compute-sanitizer cannot check this card "
              f"({secs:.1f} s): {tail}")
        return {"ran": False, "reason": tail, "seconds": secs}
    summary = [ln for ln in lines if "ERROR SUMMARY:" in ln]
    errors = summary[-1].split("ERROR SUMMARY:")[1].split()[0] \
        if summary else None
    ran = any(ln.startswith("memcheck_route: ") for ln in lines)
    if reports or errors != "0" or rc != 0 or not ran:
        print(out[-4000:])
        raise AssertionError(
            f"memcheck of the two-GEMM route: exit {rc}, "
            f"{summary[-1] if summary else 'no ERROR SUMMARY'}, "
            f"{len(reports)} access reports, script's line "
            f"{'printed' if ran else 'missing'}")
    print(f"  [5l] memcheck of the two-GEMM route (factored_dense 640, "
          f"factored_rows_tail (640, 640), mlp_infer_tail 1152): "
          f"{summary[-1]} ({secs:.1f} s)")
    return {"ran": True, "summary": summary[-1], "seconds": secs}


# phase 5l: every depth and width the port trains, and 256 Tx antennas
WIDE_MODELS = ((2048, 2048), (4096, 1024), (1536, 640), (1024,),
               (1024, 1024, 1024))
WIDE_PACKETS = 64                  # phase 5l: BS32 requests (S = 256)
NT256_PACKETS = 128                # phase 5l: Nt 256 requests (S = 512)
WIDE_TIME_S = 4096                 # phase 5l: the BS32 rows' timed S


def wide_phase(dev, smi, counted, require_launched) -> dict:
    """Phase 5l: the models of any depth and width that the port trains,
    served on the card. Each model (seeded weights, written as a
    checkpoint, loaded by CSIPredictor) answers one request through
    estimate_full and one through all_pairs, its launches of kernels 1
    and 2 counted; the served estimates are held to the float32 path
    (PIPE_LIMITS), and each kernel of the depth's chain to its plain
    version on the card (the BS32 limits of phase 3); at Nt 256 also
    kernel 1's bf16 store and sums and kernels 3 and 4; at (2048, 2048)
    kernel 5 through predict_complex_pallas. Then times each new kernel
    shape (CUDA events) beside its plain version, its bound and a
    library yardstick. Returns the served NMSEs, the counts and the
    kernel rows (for the kernels line)."""
    import torch

    from mamimo_tpu_torch.config import SimConfig, TrainConfig
    from mamimo_tpu_torch.models.mlp import (
        _factored_all_pairs,
        plane,
        predict_complex,
    )
    from mamimo_tpu_torch.models.predictor import CSIPredictor, full_f32_matmul
    from mamimo_tpu_torch.ops.estimate import (
        ls_estimate_matmul,
        ls_estimate_planes,
        ls_planes_constants,
    )
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        _heads_plain,
        _hidden_plain,
        _out_plain,
        _tail_plain,
        factored_dense,
        factored_heads,
        factored_rows_tail,
        factored_sig_proj,
        factored_tail,
        fused_factored_planes,
    )
    from mamimo_tpu_torch.ops.kernels.fused_ls import (
        _ls_v1_plain,
        _ls_v2_plain,
        _ssq_plain,
        ls_estimate_pallas,
        ls_pair_kernel,
        ls_planes_pallas_v2_constants,
        ls_planes_v1,
        ls_planes_v2,
        ls_v2_tiles,
        pair_planes,
    )
    from mamimo_tpu_torch.ops.kernels.mlp_infer import (
        _tail_plain as _mlp_tail_plain,
        mlp_infer_tail,
        predict_complex_pallas,
        prepare_mlp_infer_weights,
    )
    from mamimo_tpu_torch.bench import (
        _planes_to_time_major,
        make_estimation_fn_planes,
        make_estimation_fn_serving_r3,
    )
    from mamimo_tpu_torch.ops.ltf import pilot_p_matrix
    from mamimo_tpu_torch.train.ckpt import save_checkpoint

    bf16 = torch.bfloat16
    t0 = time.perf_counter()
    rows, served, counts = [], {}, {}
    nbytes_of = lambda *ts: sum(t.numel() * t.element_size()  # noqa: E731
                                for t in ts)

    def timed(name, shape, src, kern, plain, lib, nbytes, ops, launches,
              path, err, replaces="mamimo_tpu/ops/pallas/"
              "fused_factored.py:169", in_line=True):
        """Time one kernel shape; a row of the kernels line unless
        in_line is False (a kernel no path of this phase launches)."""
        ms = time_ms(kern, iters=10)
        plain_ms = time_ms(plain, iters=2, warmup=1)
        lib_ms = time_ms(lib, iters=10) if lib is not None else None
        bms, by = bound_ms(nbytes, ops)
        print(f"  {name} [{shape}]: {ms:.5f} ms (bound {bms:.5f} ms by {by},"
              f" {bms / ms * 100:.1f}% of it); plain {plain_ms:.4f} ms; "
              f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
              f"  [{smi}]")
        if not in_line:
            return
        rows.append({"name": name, "shape": shape, "route": "cuda",
                     "source": f"mamimo_tpu_torch/csrc/{src}",
                     "replaces": replaces, "launches": launches,
                     "launches_in": path,
                     "max_abs_err": err["max_abs_err"],
                     "nmse_db": err["nmse_db"], "exact": False, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": lib_ms, "call_ms": None,
                     "ms_from": "events", "call_ms_from": "events"})

    def chain_names(hidden):
        """Kernel 2's kernels for a model: the fused tail for 2 hidden
        layers of at most 1024 units in the first, else the per-head rows
        through device memory (fused_factored_planes' routing), the rows
        tail of bf16 rows on its two GEMMs."""
        d = len(hidden)
        if d == 2 and hidden[0] <= 1024:
            return ("factored_sig_proj", "factored_tail")
        return ("factored_sig_proj", "factored_heads") \
            + (("factored_dense",) if d != 2 else ()) \
            + (("factored_rows_tail", "factored_rows_tail gemms")
               if d >= 2 else ())

    def layer_library(p, k, h):
        """One bf16 matmul and its epilogue: hidden layer k on rows h."""
        y = torch.relu(torch.bmm(h, p[f"w{k}"]) + p[f"b{k}"])
        return (y * p[f"a{k}"] + p[f"c{k}"]).to(bf16)

    for hidden in WIDE_MODELS + ("nt256",):
        t_model = time.perf_counter()
        big_nt = hidden == "nt256"
        cfg = SimConfig(num_tx=256, num_rx=4) if big_nt else SimConfig()
        tcfg = TrainConfig(hidden=(1024, 1024)) if big_nt \
            else TrainConfig(hidden=hidden)
        tag = f"Nt {cfg.num_tx}, hidden {tcfg.hidden}"
        nt, nr, L, C = cfg.num_tx, cfg.num_rx, cfg.len_ltf, cfg.num_carriers
        depth = len(tcfg.hidden)
        packets = NT256_PACKETS if big_nt else WIDE_PACKETS
        params, bn = make_model(cfg, tcfg, seed=70 + depth, device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            save_checkpoint(str(Path(tmp) / "best"), cfg, tcfg, params, bn)
            pred = CSIPredictor(tmp, device=dev)
        gr = torch.Generator().manual_seed(71)
        req = torch.randn((2, packets * nr, L), generator=gr).numpy()
        names = ("ls_planes_v2",) + chain_names(tcfg.hidden)
        (h_ls, h_dnn), cnt = counted(lambda: pred.estimate_full(req))
        require_launched(f"estimate_full, {tag}", cnt, names)
        rx = req.reshape(2, packets, nr, L)
        ap, cnt_ap = counted(lambda: pred.all_pairs(rx))
        require_launched(f"all_pairs, {tag}", cnt_ap,
                         chain_names(tcfg.hidden))
        counts[tag] = {"estimate_full": cnt, "all_pairs": cnt_ap}
        x0 = torch.from_numpy(req).to(dev)
        ref_ls = ls_estimate_planes(cfg, x0, ls_planes_constants(
            cfg, device=dev))
        with full_f32_matmul():
            ref_d = _factored_all_pairs(cfg, tcfg, params, bn, x0)
        ref_dnn = torch.complex(ref_d[0], ref_d[1])
        shape = (packets * nr, nt, C)
        if h_ls.shape != shape or h_dnn.shape != shape:
            raise AssertionError(f"{tag}: served {h_ls.shape}, "
                                 f"{h_dnn.shape}, want {shape}")
        on = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
        served[tag] = {
            "h_ls": check(f"[5l] {tag}: estimate_full h_ls ({packets} "
                          f"packets) vs the f32 LS", on(h_ls), ref_ls,
                          PIPE_LIMITS["served_ls_db"]),
            "h_dnn": check(f"[5l] {tag}: estimate_full h_dnn vs the f32 "
                           f"factored DNN", on(h_dnn), ref_dnn,
                           PIPE_LIMITS["served_dnn_db"]),
            "all_pairs": check(f"[5l] {tag}: all_pairs vs the f32 factored "
                               f"DNN", on(ap), ref_dnn.view(
                                   packets, nr, nt, C),
                               PIPE_LIMITS["served_dnn_db"])}
        del ref_d, ref_dnn, ref_ls
        # each kernel of the chain against its plain version on the card
        prep, k90 = pred._kernel_weights()
        x16 = x0.to(bf16)
        sp = factored_sig_proj(x16, prep["w1"], prep["w1t"])
        errs = {"factored_sig_proj": check(
            f"  factored_sig_proj, {tag}, vs f32 x @ W1", sp,
            x16.float() @ prep["w1"].float(), -70.0)}
        g = torch.Generator(device=dev).manual_seed(72)
        fused = "factored_tail" in chain_names(tcfg.hidden)
        if fused:
            errs["factored_tail"] = check(
                f"  factored_tail, {tag}, vs its plain version",
                factored_tail(prep, sp, C), _tail_plain(prep, sp, C), -40.0)
        else:
            h = factored_heads(prep, sp)
            errs["factored_heads"] = check(
                f"  factored_heads, {tag}, vs its plain version", h,
                _heads_plain(prep, sp).view(2, -1, sp.shape[2]), -40.0)
            if not torch.equal(h, heads_rows_fused(prep, sp)):
                raise AssertionError(f"factored_heads, {tag}: not bit for "
                                     f"bit the plain version's rows")
            print(f"  factored_heads, {tag}: bit for bit the plain "
                  f"version's bf16 rows (product and sum in one rounding)")
            # factored_dense (on the tails' GEMM, mm_sm90.cuh) also on
            # ragged rows (a cluster's second tile past them) and 1 row
            m = h.shape[1] - 3
            for k in range(2, depth):
                hk = factored_dense(prep, k, h)
                errs["factored_dense"] = check(
                    f"  factored_dense layer {k}, {tag}, vs its plain "
                    f"version", hk, _hidden_plain(prep, k, h), -40.0)
                for what, he in ((f"{m} rows", h[:, :m]), ("1 row", h[:, :1])):
                    check(f"  factored_dense layer {k} {what}, {tag}, vs its "
                          f"plain version", factored_dense(prep, k, he),
                          _hidden_plain(prep, k, he), -40.0)
                h = hk
            if depth == 1:
                y = factored_dense(prep, 2, h, C)
                errs["factored_dense"] = check(
                    f"  factored_dense output layer, {tag}, vs its plain "
                    f"version", y, _out_plain(prep, h, C), -40.0)
                if not torch.equal(factored_dense(prep, 2, h, C, bf16),
                                   y.to(bf16)):
                    raise AssertionError(f"factored_dense output layer, "
                                         f"{tag}: the bf16 store is not the "
                                         f"f32 result rounded")
                print(f"  factored_dense output layer, {tag}: bf16 store = "
                      f"the f32 result rounded")
                for what, he in ((f"{m} rows", h[:, :m]), ("1 row", h[:, :1])):
                    check(f"  factored_dense output layer {what}, {tag}, vs "
                          f"its plain version", factored_dense(prep, 2, he, C),
                          _out_plain(prep, he, C), -40.0)
            else:
                errs["factored_rows_tail"] = check(
                    f"  factored_rows_tail, {tag}, vs its plain version",
                    factored_rows_tail(prep, h, C),
                    _out_plain(prep, _hidden_plain(prep, depth, h), C),
                    -40.0)
                # ragged rows (a cluster's last block past them), 1 row;
                # above 1024 units the rows stream slab by slab
                m = h.shape[1] - 3
                for what, he in ((f"{m} rows", h[:, :m]), ("1 row", h[:, :1])):
                    check(f"  factored_rows_tail {what}, {tag}, vs its plain "
                          f"version", factored_rows_tail(prep, he, C),
                          _out_plain(prep, _hidden_plain(prep, depth, he),
                                     C), -40.0)
        with full_f32_matmul():
            check(f"  fused_factored_planes, {tag}, vs f32 "
                  f"_factored_all_pairs", fused_factored_planes(
                      cfg, tcfg, prep, x16), _factored_all_pairs(
                      cfg, tcfg, params, bn, x16.float()), -40.0)
        del sp, h_ls, h_dnn, ap
        if big_nt:
            # kernel 1's modes at Nt 256 (the halves body), its edges,
            # a seq rank, and kernels 3 and 4 at Nt 256
            x32 = x16.float()
            errs["ls_planes_v2"] = check(
                f"  ls_planes_v2, {tag}, vs its plain version (f32)",
                ls_planes_v2(cfg, x16, k90), _ls_v2_plain(cfg, x32), -45.0)
            modes = check_v2_modes(cfg, x16, k90, f"{tag}, S = {x16.shape[1]}")
            errs["ls_planes_v2 bf16 ssq"] = modes[(bf16, True)]
            check_v2_modes(cfg, x16[:, :5].contiguous(), k90, f"{tag}, S = 5")
            check(f"  ls_planes_v2 S = 1, {tag}, vs its plain version",
                  ls_planes_v2(cfg, x16[:, :1], k90),
                  _ls_v2_plain(cfg, x32[:, :1]), -45.0)
            lq = L // 2
            check(f"  ls_planes_v2 seq rank 1 of 2, {tag}, vs its plain "
                  f"version", ls_planes_v2(
                      cfg, x16[:, :, lq:].contiguous(), k90,
                      seq_shard=(1, 2)),
                  _ls_v2_plain(cfg, x32[:, :, lq:], (1, 2)), -45.0)
            ref_raw = torch.stack(_ls_v1_plain(cfg, x16, 8, torch.float32))
            for dt in (torch.float32, bf16):
                hr, hi = ls_planes_v1(cfg, x16, k90, out_dtype=dt)
                check_pads_zero("ls_planes_v1", hr, hi, x16.shape[1], nt, C)
                errs.setdefault("ls_planes_v1", check(
                    f"  ls_planes_v1 raw {str(dt)[6:]}, {tag}, vs its plain "
                    f"version, pads zero", torch.stack([hr, hi]), ref_raw,
                    -45.0))
            for s_odd in (3, 1):
                xo = x16[:, :s_odd]
                r1 = torch.stack(_ls_v1_plain(cfg, xo, 8, torch.float32))
                check(f"  ls_planes_v1 S = {s_odd}, {tag}", torch.stack(
                    ls_planes_v1(cfg, xo, k90)), r1, -45.0)
            del ref_raw, hr, hi
            rxp = _planes_to_time_major(x32[:, :8 * nr], nr)   # 8 packets
            with full_f32_matmul():
                ref_pp = ls_estimate_matmul(cfg, rxp)
            errs["ls_pair_kernel"] = check(
                f"  ls_estimate_pallas (8 packets, float32 mode), {tag}, vs "
                f"ls_estimate_matmul (f32)",
                ls_estimate_pallas(cfg, rxp), ref_pp, F32_LIMIT_DB)
            # its bf16 mode (the halves body), bf16 pair planes
            errs["ls_pair_kernel bf16"] = check(
                f"  ls_pair_kernel (8 packets, bf16 pair planes), {tag}, vs "
                f"ls_estimate_matmul (f32)", ls_pair_kernel(
                    cfg, pair_planes(rxp), nr, k90), ref_pp, -45.0)
            del rxp, ref_pp
            # the two planes paths whose LS modes these are: the bf16
            # store and sums (pallas_ls_v2_serving_r3, as entry), and
            # kernel 3 (the planes path ls_pallas), counted
            h32 = ls_estimate_planes(cfg, x32, ls_planes_constants(
                cfg, device=dev))
            with full_f32_matmul():
                d32 = _factored_all_pairs(cfg, tcfg, params, bn, x32)
            fn_r3 = make_estimation_fn_serving_r3(cfg, tcfg, params, bn)
            (ssq_r3, y2_r3), cnt_r3 = counted(lambda: fn_r3(x16))
            require_launched(f"pallas_ls_v2_serving_r3, {tag}", cnt_r3,
                             names)
            served[tag]["r3_ssq"] = check(
                f"[5l] {tag}: pallas_ls_v2_serving_r3 sums of h^2 vs the "
                f"f32 LS's", ssq_r3, _ssq_plain(torch.stack(
                    [h32.real, h32.imag]), nt), -40.0)
            served[tag]["r3_y2"] = check(
                f"[5l] {tag}: pallas_ls_v2_serving_r3 y2 vs f32 "
                f"_factored_all_pairs", y2_r3, d32, -40.0)
            fn_v1 = make_estimation_fn_planes(cfg, tcfg, params, bn,
                                              input_bf16=True, ls_pallas=True)
            (v1_ls, v1_dnn), cnt_v1 = counted(lambda: fn_v1(x16))
            require_launched(f"planes path ls_pallas, {tag}", cnt_v1,
                             ("ls_planes_v1",) + chain_names(tcfg.hidden))
            served[tag]["ls_pallas_h_ls"] = check(
                f"[5l] {tag}: planes path ls_pallas h_ls vs the f32 LS",
                v1_ls, h32, -45.0)
            counts[tag].update({"pallas_ls_v2_serving_r3": cnt_r3,
                                "ls_pallas": cnt_v1})
            del fn_r3, fn_v1, ssq_r3, y2_r3, v1_ls, v1_dnn, h32, d32
        if hidden == WIDE_MODELS[0]:
            # kernel 5: h1 of 2048 units streams through its tail
            with full_f32_matmul():
                prep_mlp = prepare_mlp_infer_weights(tcfg, params, bn)
            sig = torch.complex(torch.randn((256, L), generator=g,
                                            device=dev),
                                torch.randn((256, L), generator=g,
                                            device=dev))
            pil = pilot_p_matrix(nt, device=dev).T[
                torch.arange(256, device=dev) % nt]
            got_pc, cnt_pc = counted(lambda: predict_complex_pallas(
                cfg, tcfg, prep_mlp, None, sig, pil))
            require_launched(f"predict_complex_pallas, {tag}", cnt_pc,
                             ("mlp_infer_layer1", "mlp_infer_tail",
                              "mlp_infer_tail gemms"))
            counts[tag]["predict_complex_pallas"] = cnt_pc
            with full_f32_matmul():
                ref_pc = predict_complex(cfg, tcfg, params, bn, sig, pil)
            served[tag]["predict_complex_pallas"] = check(
                f"[5l] {tag}: predict_complex_pallas (256 rows) vs f32 "
                f"predict_complex", got_pc, ref_pc, -40.0)
            pm0 = plane(prep_mlp, 0)
            h1 = torch.relu(torch.randn((131, pm0["w2"].shape[0]),
                                        generator=g, device=dev)).to(bf16)
            for what, he in (("131 rows", h1), ("1 row", h1[:1])):
                errs.setdefault("mlp_infer_tail", check(
                    f"  mlp_infer_tail {what}, {tag}, vs its plain version",
                    mlp_infer_tail(pm0, he), _mlp_tail_plain(pm0, he),
                    -40.0))

        # timing at the main path's shapes: S = 4096 at BS32 (131072
        # rows), the request's S = 512 at Nt 256 (131072 rows too)
        S = x16.shape[1] if big_nt else WIDE_TIME_S
        path = f"estimate_full x1, {tag}"
        H1 = prep["w1"].shape[2]
        if big_nt:
            xb16, xb32 = x16, x16.float()
            f32c = ls_planes_constants(cfg, device=dev)
            bv2, _ = ls_planes_pallas_v2_constants(cfg, 1, bf16, dev)
            cp_ = bv2.shape[1] // 2
            pmat = f32c[2]

            def ls_library():
                t = torch.matmul(xb16.view(2, S * nt, cfg.sym_len),
                                 bv2).float()
                zr = t[0, :, :C] - t[1, :, cp_:cp_ + C]
                zi = t[0, :, cp_:cp_ + C] + t[1, :, :C]
                return torch.matmul(pmat, torch.stack([zr, zi]).view(
                    2, S, nt, C))

            ls_in = 2 * S * nt * cfg.fft_length * 2 + k90.bt.numel() * 2
            ls_ops = 2.0 * (S * nt) * (2 * cfg.fft_length) * (2 * C)
            lsrc = "mamimo_tpu/ops/pallas/fused_ls.py:"
            timed("ls_planes_v2", f"Nt 256: planes (2, {S}, {L}) bf16 -> "
                  f"(2, {S}, {nt}, {C}) f32", "ls_v2.cu",
                  lambda: ls_planes_v2(cfg, xb16, k90),
                  lambda: ls_estimate_planes(cfg, xb32, f32c), ls_library,
                  ls_in + 2 * S * nt * C * 4, ls_ops, cnt["ls_planes_v2"],
                  path, errs["ls_planes_v2"], replaces=lsrc + "424")
            tiles_b = ls_v2_tiles(S, nt)
            timed("ls_planes_v2", f"Nt 256: planes (2, {S}, {L}) bf16 -> "
                  f"(2, {S}, {nt}, {C}) bf16 + sums of h^2 ({tiles_b}, 2, "
                  f"{C}) f32", "ls_v2.cu",
                  lambda: ls_planes_v2(cfg, xb16, k90, out_dtype=bf16,
                                       with_ssq=True),
                  lambda: _ls_v2_plain(cfg, xb32, None, bf16, True),
                  lambda: (lambda h: (h.to(bf16), (h * h).view(
                      2, tiles_b, -1, C).sum(2)))(ls_library()),
                  ls_in + 2 * S * nt * C * 2 + tiles_b * 2 * C * 4, ls_ops,
                  cnt_r3["ls_planes_v2"],
                  f"pallas_ls_v2_serving_r3 x1, {tag}",
                  errs["ls_planes_v2 bf16 ssq"], replaces=lsrc + "424")
            rows_out = -(-S // 8) * 8 * nt
            timed("ls_planes_v1", f"Nt 256: planes (2, {S}, {L}) bf16 -> "
                  f"raw 2 x ({rows_out}, {cp_}) bf16", "ls_v1.cu",
                  lambda: ls_planes_v1(cfg, xb16, k90, out_dtype=bf16),
                  lambda: _ls_v1_plain(cfg, xb16, 8, bf16), ls_library,
                  ls_in + 2 * rows_out * cp_ * 2, ls_ops,
                  cnt_v1["ls_planes_v1"], f"planes path ls_pallas x1, {tag}",
                  errs["ls_planes_v1"], replaces=lsrc + "253")
            rx_b = _planes_to_time_major(xb32, nr)
            ppl = pair_planes(rx_b)
            timed("ls_pair_kernel", f"Nt 256: rx ({S // nr}, {L}, {nr}) c64 "
                  f"-> ({S // nr}, {C}, {nt}, {nr}) c64", "ls_pair.cu",
                  lambda: ls_pair_kernel(cfg, ppl, nr, k90),
                  lambda: ls_estimate_matmul(cfg, rx_b), ls_library,
                  ls_in + S * nt * C * 8, ls_ops, 0,
                  "pallas_full is not run at Nt 256 (its materialized "
                  "rows are S*Nt x (L + Nt))", errs["ls_pair_kernel bf16"],
                  replaces=lsrc + "110", in_line=False)
            del xb32, rx_b, ppl
        else:
            # the BS32 models all take the per-head rows (none is a fused
            # tail's: two layers above 1024 units, or another depth)
            spb = torch.randn((2, S, H1), generator=g, device=dev) * 0.5
            h = factored_heads(prep, spb)
            timed("factored_heads", f"hidden {tcfg.hidden}: sig_proj "
                  f"(2, {S}, {H1}) f32 -> rows (2, {S * nt}, {H1}) bf16",
                  "fused_factored.cu",
                  lambda: factored_heads(prep, spb),
                  lambda: _heads_plain(prep, spb), None,
                  nbytes_of(spb, prep["hb"], prep["a1"], prep["c1"], h),
                  0.0, cnt["factored_heads"], path,
                  errs["factored_heads"])
            M = S * nt
            for k in range(2, depth):
                hk = factored_dense(prep, k, h)
                check(f"  factored_dense layer {k}, {tag}, rows (2, {M}, "
                      f"{h.shape[2]}), vs its plain version", hk,
                      _hidden_plain(prep, k, h), -40.0)
                kin, kout = h.shape[2], hk.shape[2]
                timed("factored_dense", f"hidden {tcfg.hidden}, layer "
                      f"{k}: rows (2, {M}, {kin}) bf16 -> (2, {M}, "
                      f"{kout}) bf16", "fused_factored.cu",
                      lambda h=h, k=k: factored_dense(prep, k, h),
                      lambda h=h, k=k: _hidden_plain(prep, k, h),
                      lambda h=h, k=k: layer_library(prep, k, h),
                      nbytes_of(h, prep[f"w{k}t"], prep[f"b{k}"],
                                prep[f"a{k}"], prep[f"c{k}"], hk),
                      2.0 * 2 * M * kin * kout, cnt["factored_dense"],
                      path, errs["factored_dense"])
                h = hk
            kin, o = h.shape[2], depth + 1
            if depth == 1:
                check(f"  factored_dense output layer, {tag}, rows (2, {M}, "
                      f"{kin}), vs its plain version", factored_dense(
                          prep, 2, h, C), _out_plain(prep, h, C), -40.0)
                timed("factored_dense", f"hidden {tcfg.hidden}, output "
                      f"layer: rows (2, {M}, {kin}) bf16 -> (2, {M}, "
                      f"{C}) f32", "fused_factored.cu",
                      lambda: factored_dense(prep, 2, h, C),
                      lambda: _out_plain(prep, h, C),
                      lambda: torch.bmm(h, prep["w2"])[..., :C]
                      + prep["b2"][..., :C],
                      nbytes_of(h, prep["w2t"], prep["b2"])
                      + 2 * M * C * 4, 2.0 * 2 * M * kin * C,
                      cnt["factored_dense"], path,
                      errs["factored_dense"])
            else:
                hd = prep[f"w{depth}"].shape[2]
                timed("factored_rows_tail", f"hidden {tcfg.hidden}: rows "
                      f"(2, {M}, {kin}) bf16 -> (2, {M}, {C}) f32",
                      "fused_factored.cu",
                      lambda: factored_rows_tail(prep, h, C),
                      lambda: _out_plain(prep, _hidden_plain(
                          prep, depth, h), C),
                      lambda: torch.bmm(layer_library(prep, depth, h),
                                        prep[f"w{o}"])[..., :C],
                      nbytes_of(h, prep[f"w{depth}t"], prep[f"b{depth}"],
                                prep[f"a{depth}"], prep[f"c{depth}"],
                                prep[f"w{o}t"], prep[f"b{o}"])
                      + 2 * M * C * 4,
                      2.0 * 2 * M * (kin * hd + hd * C),
                      cnt["factored_rows_tail"], path,
                      errs["factored_rows_tail"])
            del h
            if hidden == WIDE_MODELS[0]:
                M = S * nt
                h1b = torch.relu(torch.randn((M, H1), generator=g,
                                             device=dev)).to(bf16)
                w3c = pm0["w3"][:, :C]
                timed("mlp_infer_tail", f"hidden {tcfg.hidden}: h1 ({M}, "
                      f"{H1}) bf16 -> ({M}, {C}) f32", "mlp_infer.cu",
                      lambda: mlp_infer_tail(pm0, h1b),
                      lambda: _mlp_tail_plain(pm0, h1b),
                      lambda: torch.matmul((torch.relu(torch.matmul(
                          h1b, pm0["w2"]) + pm0["b2"]) * pm0["s2"]
                          + pm0["t2"]).to(bf16), w3c) + pm0["b3"],
                      nbytes_of(h1b, pm0["w2"], pm0["b2"], pm0["s2"],
                                pm0["t2"], w3c, pm0["b3"]) + M * C * 4,
                      2.0 * M * (H1 * pm0["w2"].shape[1]
                                 + pm0["w2"].shape[1] * C),
                      cnt_pc["mlp_infer_tail"],
                      f"predict_complex_pallas x1, {tag}",
                      errs["mlp_infer_tail"],
                      replaces="mamimo_tpu/ops/pallas/mlp_infer.py:144")
                del h1b, prep_mlp, pm0
            del spb
        del pred, prep, params, bn, x0, x16
        torch.cuda.empty_cache()
        print(f"  [5l] {tag}: {time.perf_counter() - t_model:.1f} s")
    mc = memcheck_route(dev)
    secs = time.perf_counter() - t0
    print(f"[5l wide] {len(WIDE_MODELS) + 1} models served through kernels "
          f"1 and 2, each kernel held to its plain version; {secs:.1f} s")
    return {"served_nmse_db": {k: {n: v["nmse_db"] for n, v in d.items()}
                               for k, d in served.items()},
            "launches": counts, "rows": rows, "memcheck": mc,
            "seconds": secs}


# phase 5m: the float32 modes of kernels 1, 3 and 4, kernel 6's bf16 and
# float32 modes
TF32_FLOPS = 495e12                # H100 SXM TF32 dense tensor cores
# a float32 mode against its float32 plain version (TF32 off), and kernel
# 6 against float64 products: one TF32 pass would be about -60 dB
F32_LIMIT_DB = -90.0
F32_SHARD_REL = 1e-4               # the sharded forms (section 2 of PERF.md)
MM_SHAPES = ((4096, 10240, 1024), (131072, 1024, 1024))   # (M, K, N) timed


def f32_modes_phase(dev, smi, counted, require_launched) -> dict:
    """Phase 5m: float32 planes through kernels 1 (full and seq mode, f32
    and bf16 store, sums of h^2), 3 (raw, complex, as_planes) and 4
    (complex64 rx) in their float32 mode, at BS32 (S = 256 and 5), Nt 8
    and Nt 256, each within F32_LIMIT_DB of its float32 plain version
    (the bf16 mode's dB on the same planes printed beside), the bf16
    stores exactly the float32 result rounded, the sums within 1e-4 per
    tile and as_planes exactly the complex form, NaN and +-Inf samples
    propagated as by the plain versions; sharded_ls_pallas_v2
    data and seq on 4 virtual ranks with float32 planes against the
    unsharded float32 plain LS (F32_SHARD_REL), counted; matmul_pallas
    on bf16 and float32 operands against float64 products
    (F32_LIMIT_DB) at ragged and timed shapes, out_dtype=bf16 exactly
    the float32 result rounded, counted. Then holds kernel 1 and 3's
    float32 modes to their plain versions at the bench shape (S = 4096,
    F32_LIMIT_DB), times them there, kernels 1, 3 and 4's at Nt 256 (S =
    512, the halves body) the same way, and kernel 6 at
    MM_SHAPES beside their plain versions, bounds (float32 bytes once,
    products once at the TF32 peak) and library calls. Returns the
    errors, the counts and the kernel rows (for the kernels line)."""
    import torch

    from mamimo_tpu_torch.bench import _planes_to_time_major
    from mamimo_tpu_torch.config import SimConfig
    from mamimo_tpu_torch.ops.estimate import (
        ls_estimate_matmul,
        ls_estimate_planes,
        ls_planes_constants,
    )
    from mamimo_tpu_torch.ops.kernels.fused_ls import (
        _ls_v1_plain,
        _ls_v2_plain,
        _ssq_plain,
        ls_estimate_pallas,
        ls_pair_kernel,
        ls_planes_pallas,
        ls_planes_pallas_v2_constants,
        ls_planes_v1,
        ls_planes_v2,
        ls_raw_to_complex,
        ls_sm90_constants,
        pair_planes,
    )
    from mamimo_tpu_torch.ops.kernels.int8_mm import (
        _matmul_float,
        _matmul_float_plain,
        matmul_float,
        matmul_pallas,
    )
    from mamimo_tpu_torch.parallel.mesh import make_mesh
    from mamimo_tpu_torch.parallel.sharded import sharded_ls_pallas_v2
    from mamimo_tpu_torch.utils.numerics import full_f32_matmul

    f32, bf16 = torch.float32, torch.bfloat16
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(90)
    errs, counts, rows = {}, {}, []
    print("[5m float32 modes] float32 input through kernels 1, 3 and 4; "
          "kernel 6 on bf16 and float32 operands")

    def db_of(got, ref):
        g64, r64 = got.double(), ref.double()
        return 10 * float(torch.log10((g64 - r64).square().sum()
                                      / r64.square().sum()))

    def same(what, got, ref):
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            raise AssertionError(f"{what}: not identical")
        print(f"  {what}: identical")

    def ls_checks(cfg, s, tag, seqs, packets):
        nt, nr, L, C = cfg.num_tx, cfg.num_rx, cfg.len_ltf, cfg.num_carriers
        k32, k16 = ls_sm90_constants(cfg, dev, f32), ls_sm90_constants(cfg,
                                                                      dev)
        x = torch.randn((2, s, L), generator=g, device=dev)
        ref = _ls_v2_plain(cfg, x)
        h = ls_planes_v2(cfg, x, k32)
        r = check(f"ls_planes_v2 float32, {tag}, S = {s}, vs its plain "
                  f"version (f32)", h, ref, F32_LIMIT_DB)
        print(f"    (the bf16 mode on the same planes rounded to bf16: "
              f"{db_of(ls_planes_v2(cfg, x.to(bf16), k16), ref):.2f} dB)")
        errs.setdefault("ls_planes_v2 f32", r)
        # the stores and sums: the bf16 store is the float32 result
        # rounded; the sums those of the float32 plain values
        same(f"ls_planes_v2 float32, {tag}: bf16 store = the f32 result "
             f"rounded", ls_planes_v2(cfg, x, k32, out_dtype=bf16),
             h.to(bf16))
        for seq in (None,) + tuple((i, n) for n in seqs
                                   for i in sorted({0, 1, n - 1})):
            loc = nt if seq is None else nt // seq[1]
            xq = x if seq is None else x[:, :, seq[0] * loc * cfg.sym_len:
                                         (seq[0] + 1) * loc
                                         * cfg.sym_len].contiguous()
            rq = ref if seq is None else _ls_v2_plain(cfg, xq, seq)
            what = f"ls_planes_v2 float32, {tag}" + (
                "" if seq is None else f", seq rank {seq[0]} of {seq[1]}")
            if seq is not None:
                check(f"{what} vs its plain version (f32)", ls_planes_v2(
                    cfg, xq, k32, seq_shard=seq), rq, F32_LIMIT_DB)
            for dt in (f32, bf16):
                hq, q = ls_planes_v2(cfg, xq, k32, seq_shard=seq,
                                     out_dtype=dt, with_ssq=True)
                check(f"{what}, {str(dt)[6:]} store + sums, vs its plain "
                      f"version (f32)", hq, rq, F32_LIMIT_DB if dt == f32
                      else -45.0)
                sref = _ssq_plain(rq, loc)
                rel = float(((q - sref).abs() / sref.abs().clamp_min(
                    1e-30)).max())
                again = ls_planes_v2(cfg, xq, k32, seq_shard=seq,
                                     out_dtype=dt, with_ssq=True)[1]
                print(f"  {what}, {str(dt)[6:]} store: sums {tuple(q.shape)}"
                      f", max rel err per tile {rel:.3e} (limit 1e-4) vs the "
                      f"plain version's float32 sums; second call "
                      f"{'identical' if torch.equal(q, again) else 'DIFFERS'}")
                if not (rel <= 1e-4 and torch.equal(q, again)):
                    raise AssertionError(f"{what}: sums off by {rel:.3e} or "
                                         f"not deterministic")
        # kernel 3: raw f32 and bf16, complex, as_planes
        raw8 = _ls_v1_plain(cfg, x, 8, f32)
        for block in (8, 1):
            raw_ref = torch.stack(_ls_v1_plain(cfg, x, block, f32))
            hr, hi = ls_planes_v1(cfg, x, k32, block_samples=block)
            check_pads_zero("ls_planes_v1 float32", hr, hi, s, nt, C)
            r = check(f"ls_planes_v1 float32 raw, {tag}, S = {s}, block "
                      f"{block}, vs its plain version (f32), pads zero",
                      torch.stack([hr, hi]), raw_ref, F32_LIMIT_DB)
            errs.setdefault("ls_planes_v1 f32", r)
            same(f"ls_planes_v1 float32, {tag}, block {block}: bf16 raw = "
                 f"the f32 raw rounded", torch.stack(ls_planes_v1(
                     cfg, x, k32, block_samples=block, out_dtype=bf16)),
                 torch.stack([hr, hi]).to(bf16))
        cplx = ls_planes_pallas(cfg, x, k32)
        check(f"ls_planes_pallas float32 complex, {tag}, vs its plain "
              f"version (f32)", cplx, ls_raw_to_complex(cfg, *raw8, s),
              F32_LIMIT_DB)
        for xa, ka, dt in ((x, k32, "float32"), (x.to(bf16), k16, "bf16")):
            ap = ls_planes_pallas(cfg, xa, ka, as_planes=True)
            if ap.shape != (2, s, nt, C) or ap.dtype != f32:
                raise AssertionError(f"as_planes: {tuple(ap.shape)} "
                                     f"{ap.dtype}")
            same(f"ls_planes_pallas {dt} as_planes, {tag}: densifies to the "
                 f"complex form", torch.complex(ap[0], ap[1]),
                 ls_planes_pallas(cfg, xa, ka))
        # kernel 4 on complex64 rx of whole packets
        rx = _planes_to_time_major(x[:, :packets * nr], nr)
        with full_f32_matmul():
            ref_pp = ls_estimate_matmul(cfg, rx)
        r = check(f"ls_estimate_pallas complex64, {tag}, {packets} packets, "
                  f"vs ls_estimate_matmul (f32)",
                  ls_estimate_pallas(cfg, rx, consts=k32), ref_pp,
                  F32_LIMIT_DB)
        errs.setdefault("ls_pair_kernel f32", r)

    def nonfinite_checks(cfg, s, packets):
        # NaN and +-Inf samples in symbols' fft parts (the CP is never
        # read): each float32 mode gives non-finite values exactly where
        # its plain version does, the rest within F32_LIMIT_DB of it
        nt, nr, L, C = cfg.num_tx, cfg.num_rx, cfg.len_ltf, cfg.num_carriers
        k32 = ls_sm90_constants(cfg, dev, f32)
        x = torch.randn((2, s, L), generator=g, device=dev)
        at = lambda sym, k: sym * cfg.sym_len + cfg.cp_length + k  # noqa: E731
        x[0, 1, at(0, 7)] = float("nan")
        x[1, 5, at(3, 100)] = float("inf")
        x[0, s - 2, at(nt - 1, cfg.fft_length - 1)] = -float("inf")
        # NaNs whose payload a carry of the TF32 rounding takes into the sign
        x.view(torch.int32)[0, 3, at(2, 9)] = 0x7fffffff
        x.view(torch.int32)[1, 7, at(5, 3)] = -1           # 0xffffffff
        rx = _planes_to_time_major(x[:, :packets * nr], nr)
        with full_f32_matmul():
            ref_pp = ls_estimate_matmul(cfg, rx)
        # kernel 3's pad lanes are zero by the constants' zero columns, so
        # a non-finite sample makes them NaN there: its carriers only
        raw = torch.stack(ls_planes_v1(cfg, x, k32))[:, :s * nt, :C]
        raw_ref = torch.stack(_ls_v1_plain(cfg, x, 8, f32))[:, :s * nt, :C]
        for what, got, ref in (
                ("ls_planes_v2 float32", ls_planes_v2(cfg, x, k32),
                 _ls_v2_plain(cfg, x)),
                ("ls_planes_v1 float32 raw, carriers", raw, raw_ref),
                (f"ls_estimate_pallas complex64, {packets} packets",
                 torch.view_as_real(ls_estimate_pallas(cfg, rx, consts=k32)),
                 torch.view_as_real(ref_pp))):
            bad, bad_ref = ~torch.isfinite(got), ~torch.isfinite(ref)
            n, n_ref = int(bad.sum()), int(bad_ref.sum())
            print(f"  {what}, S = {s}, NaN and +-Inf samples: {n} non-finite "
                  f"values, its plain version {n_ref}, "
                  + ("at the same places" if torch.equal(bad, bad_ref)
                     else "at OTHER places"))
            if not n_ref or not torch.equal(bad, bad_ref):
                raise AssertionError(f"{what}: non-finite samples not "
                                     f"propagated as by its plain version")
            check(f"{what}, NaN and +-Inf samples: the finite values vs its "
                  f"plain version (f32)", got[~bad], ref[~bad], F32_LIMIT_DB)

    def run_ls_checks():
        ls_checks(SimConfig(), S_CHECK, "BS32", (2, 4), S_CHECK // 4)
        ls_checks(SimConfig(), 5, "BS32", (32,), 1)
        ls_checks(SimConfig(num_tx=8, num_rx=2), 3, "Nt 8", (2, 8), 1)
        ls_checks(SimConfig(num_tx=256, num_rx=4), 8, "Nt 256", (2,), 2)
        nonfinite_checks(SimConfig(), 16, 4)

    _, counts["ls checks"] = counted(run_ls_checks)
    require_launched("phase 5m's LS checks", counts["ls checks"],
                     ("ls_planes_v2 f32", "ls_planes_v1 f32",
                      "ls_pair_kernel f32"))

    # the sharded forms on float32 planes, counted
    cfg = SimConfig()
    nt, nr, L, C = cfg.num_tx, cfg.num_rx, cfg.len_ltf, cfg.num_carriers
    x4 = torch.randn((2, 16, L), generator=g, device=dev)
    ref = _ls_v2_plain(cfg, x4)
    ref = torch.complex(ref[0], ref[1])
    sh_launches = 0
    for mode in ("data", "seq"):
        m4 = make_mesh({mode: MESH_RANKS}, devices=[dev] * MESH_RANKS)
        h, cnt = counted(lambda: sharded_ls_pallas_v2(cfg, m4, x4, mode=mode))
        rel = rel_err(torch.view_as_real(h), torch.view_as_real(ref))
        print(f"  sharded_ls_pallas_v2 {mode} {MESH_RANKS}, float32 planes: "
              f"{rel:.3e} of the unsharded float32 plain LS (limit "
              f"{F32_SHARD_REL}); launches {cnt}")
        if not rel <= F32_SHARD_REL or cnt["ls_planes_v2 f32"] != MESH_RANKS:
            raise AssertionError(f"sharded_ls_pallas_v2 {mode}: {rel:.3e}, "
                                 f"{cnt}")
        errs[f"sharded {mode} rel"] = rel
        counts[f"sharded_ls_pallas_v2 {mode}"] = cnt
        sh_launches += cnt["ls_planes_v2 f32"]

    # kernel 6: bf16 and float32 operands against float64 products; the
    # bf16 kernel reads B (K, N) as given (MN-major), a transposed view of
    # a row-major Bt as it lies (K-major), and a copy of B.T where N % 8
    # (259 x 130); its bf16 store (the STAGED epilogue, TMA stores) the
    # f32 result rounded
    def mm_checks():
        for dt in (bf16, f32):
            for m, k, n in ((129, 72, 40), (1, 72, 40), (259, 136, 130)) \
                    + MM_SHAPES:
                a = torch.randn((m, k), generator=g, device=dev).to(dt)
                b = torch.randn((k, n), generator=g, device=dev).to(dt)
                got = matmul_pallas(a, b)
                r = check(f"matmul_pallas {str(dt)[6:]} ({m}, {k}) @ ({k}, "
                          f"{n}) vs float64", got, a.double() @ b.double(),
                          F32_LIMIT_DB)
                errs.setdefault(f"matmul_pallas {str(dt)[6:]} {m}", r)
                same(f"matmul_pallas {str(dt)[6:]} ({m}, {k}) @ ({k}, {n}): "
                     f"out_dtype=bf16 = the f32 result rounded",
                     matmul_pallas(a, b, out_dtype=bf16), got.to(bf16))
                if dt == bf16 and m == 129:
                    bv = b.T.contiguous().T          # Bt's transposed view
                    same(f"matmul_pallas bf16 ({m}, {k}) @ ({k}, {n}), B a "
                         f"transposed view (K-major) = B row-major",
                         matmul_pallas(a, bv), got)
                del a, b, got

    _, counts["matmul"] = counted(mm_checks)
    require_launched("phase 5m's GEMM checks", counts["matmul"],
                     ("matmul_float", "matmul_float f32"))

    # the bench shape (S = 4096, many tiles a consumer warpgroup) on
    # genuine float32 planes (nonzero low TF32 parts): kernel 1 and 3's
    # float32 modes held to their plain versions, then timed
    S = BENCH_PACKETS * nr
    xb = torch.randn((2, S, L), generator=g, device=dev)
    k32 = ls_sm90_constants(cfg, dev, f32)
    errs["ls_planes_v2 f32 bench"] = check(
        f"ls_planes_v2 float32, BS32, bench shape S = {S}, vs its plain "
        f"version (f32)", ls_planes_v2(cfg, xb, k32), _ls_v2_plain(cfg, xb),
        F32_LIMIT_DB)
    errs["ls_planes_v1 f32 bench"] = check(
        f"ls_planes_v1 float32 raw, BS32, bench shape S = {S}, vs its plain "
        f"version (f32)", torch.stack(ls_planes_v1(cfg, xb, k32)),
        torch.stack(_ls_v1_plain(cfg, xb, 8, f32)), F32_LIMIT_DB)
    torch.cuda.empty_cache()
    f32c = ls_planes_constants(cfg, device=dev)
    bv2, _ = ls_planes_pallas_v2_constants(cfg, 1, f32, dev)
    cp_ = bv2.shape[1] // 2

    def ls_library():
        # the float32 DFT-select as one matmul a plane, TF32 off, then the
        # despread
        t = torch.matmul(xb.view(2, S * nt, cfg.sym_len), bv2)
        zr = t[0, :, :C] - t[1, :, cp_:cp_ + C]
        zi = t[0, :, cp_:cp_ + C] + t[1, :, :C]
        return torch.matmul(f32c[2], torch.stack([zr, zi]).view(2, S, nt, C))

    def timed(name, shape, src, repl, kern, plain, lib, nbytes, ops, peak,
              launches, path, err, call=None):
        ms = time_ms(kern, iters=10)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        lib_ms = time_ms(lib, iters=10)
        call_ms = time_ms(call, iters=10) if call is not None else None
        bms, by = bound_ms(nbytes, ops, peak)
        print(f"  {name} [{shape}]: {ms:.5f} ms (bound {bms:.5f} ms by {by},"
              f" {bms / ms * 100:.1f}% of it); plain {plain_ms:.4f} ms; "
              f"library {lib_ms:.4f} ms"
              + (f"; whole wrapper {call_ms:.4f} ms" if call else "")
              + f"  [{smi}]")
        rows.append({"name": name, "shape": shape, "route": "cuda",
                     "source": f"mamimo_tpu_torch/csrc/{src}",
                     "replaces": repl, "launches": launches,
                     "launches_in": path, "max_abs_err": err["max_abs_err"],
                     "nmse_db": err["nmse_db"], "exact": False, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": lib_ms, "call_ms": call_ms,
                     "ms_from": "events", "call_ms_from": "events"})

    lsrc = "mamimo_tpu/ops/pallas/fused_ls.py:"
    ls_in = 2 * S * nt * cfg.fft_length * 4 + k32.bt.numel() * 4
    ls_ops = 2.0 * (S * nt) * (2 * cfg.fft_length) * (2 * C)
    timed("ls_planes_v2", f"float32 mode: planes (2, {S}, {L}) f32 -> "
          f"(2, {S}, {nt}, {C}) f32", "ls_v2.cu", lsrc + "424",
          lambda: ls_planes_v2(cfg, xb, k32),
          lambda: ls_estimate_planes(cfg, xb, f32c), ls_library,
          ls_in + 2 * S * nt * C * 4, ls_ops, TF32_FLOPS, sh_launches,
          "sharded_ls_pallas_v2 data 4 + seq 4 on float32 planes (as "
          "dryrun_multichip, phase 5k)", errs["ls_planes_v2 f32 bench"])
    rows_out = S * nt
    timed("ls_planes_v1", f"float32 mode: planes (2, {S}, {L}) f32 -> raw "
          f"2 x ({rows_out}, {cp_}) f32", "ls_v1.cu", lsrc + "253",
          lambda: ls_planes_v1(cfg, xb, k32),
          lambda: _ls_v1_plain(cfg, xb, 8, f32), ls_library,
          ls_in + 2 * rows_out * cp_ * 4, ls_ops, TF32_FLOPS,
          counts["ls checks"]["ls_planes_v1 f32"],
          "phase 5m's checks (no serving path passes float32 planes to "
          "kernel 3)", errs["ls_planes_v1 f32 bench"])
    del xb
    torch.cuda.empty_cache()

    # kernels 1, 3 and 4's float32 mode at Nt 256 (the halves body), at
    # phase 5l's request (S = 512): held to their plain versions, timed
    # beside them, their bound and the float32 matmul LS
    c2 = SimConfig(num_tx=256, num_rx=4)
    nt2, L2, S2 = c2.num_tx, c2.len_ltf, NT256_PACKETS * c2.num_rx
    x2 = torch.randn((2, S2, L2), generator=g, device=dev)
    k2, f2 = ls_sm90_constants(c2, dev, f32), ls_planes_constants(
        c2, device=dev)
    b2, _ = ls_planes_pallas_v2_constants(c2, 1, f32, dev)
    cp2 = b2.shape[1] // 2

    def ls_library_256():
        t = torch.matmul(x2.view(2, S2 * nt2, c2.sym_len), b2)
        zr = t[0, :, :C] - t[1, :, cp2:cp2 + C]
        zi = t[0, :, cp2:cp2 + C] + t[1, :, :C]
        return torch.matmul(f2[2], torch.stack([zr, zi]).view(2, S2, nt2, C))

    rx2 = _planes_to_time_major(x2, c2.num_rx)
    pp2 = pair_planes(rx2, f32)
    with full_f32_matmul():
        ref_p2 = ls_estimate_matmul(c2, rx2)
    e2 = {"v2": check(f"ls_planes_v2 float32, Nt 256, S = {S2}, vs its "
                      f"plain version (f32)", ls_planes_v2(c2, x2, k2),
                      _ls_v2_plain(c2, x2), F32_LIMIT_DB),
          "v1": check(f"ls_planes_v1 float32 raw, Nt 256, S = {S2}, vs its "
                      f"plain version (f32)", torch.stack(ls_planes_v1(
                          c2, x2, k2)), torch.stack(_ls_v1_plain(
                              c2, x2, 8, f32)), F32_LIMIT_DB),
          "pair": check(f"ls_pair_kernel float32, Nt 256, {S2 // 4} "
                        f"packets, vs ls_estimate_matmul (f32)",
                        ls_pair_kernel(c2, pp2, c2.num_rx, k2), ref_p2,
                        F32_LIMIT_DB)}
    del ref_p2
    in2 = 2 * S2 * nt2 * c2.fft_length * 4 + k2.bt.numel() * 4
    ops2 = 2.0 * (S2 * nt2) * (2 * c2.fft_length) * (2 * C)
    n_chk = counts["ls checks"]
    chk = "phase 5m's checks (no path runs it at Nt 256)"
    timed("ls_planes_v2", f"float32 mode, Nt 256: planes (2, {S2}, {L2}) "
          f"f32 -> (2, {S2}, {nt2}, {C}) f32", "ls_v2.cu", lsrc + "424",
          lambda: ls_planes_v2(c2, x2, k2),
          lambda: ls_estimate_planes(c2, x2, f2), ls_library_256,
          in2 + 2 * S2 * nt2 * C * 4, ops2, TF32_FLOPS,
          n_chk["ls_planes_v2 f32"], chk, e2["v2"])
    timed("ls_planes_v1", f"float32 mode, Nt 256: planes (2, {S2}, {L2}) "
          f"f32 -> raw 2 x ({S2 * nt2}, {cp2}) f32", "ls_v1.cu", lsrc + "253",
          lambda: ls_planes_v1(c2, x2, k2),
          lambda: _ls_v1_plain(c2, x2, 8, f32), ls_library_256,
          in2 + 2 * S2 * nt2 * cp2 * 4, ops2, TF32_FLOPS,
          n_chk["ls_planes_v1 f32"], chk, e2["v1"])
    timed("ls_pair_kernel", f"float32 mode, Nt 256: rx ({S2 // 4}, {L2}, 4) "
          f"c64 -> ({S2 // 4}, {C}, {nt2}, 4) c64", "ls_pair.cu",
          lsrc + "110", lambda: ls_pair_kernel(c2, pp2, c2.num_rx, k2),
          lambda: ls_estimate_matmul(c2, rx2), ls_library_256,
          in2 + S2 * nt2 * C * 8, ops2, TF32_FLOPS,
          n_chk["ls_pair_kernel f32"], "ls_estimate_pallas in "
          "phase 5m's checks (no path runs it at Nt 256)", e2["pair"],
          call=lambda: ls_estimate_pallas(c2, rx2, consts=k2))
    del x2, rx2, pp2

    # kernel 6 at the DNN's layer shapes; launches of each mode's kernel
    n_f32 = counts["matmul"]["matmul_float f32"]
    mm_launches = {f32: n_f32, bf16: counts["matmul"]["matmul_float"] - n_f32}
    for dt, peak in ((bf16, BF16_FLOPS), (f32, TF32_FLOPS)):
        for m, k, n in MM_SHAPES:
            a = torch.randn((m, k), generator=g, device=dev).to(dt)
            b = torch.randn((k, n), generator=g, device=dev).to(dt)
            bt = b.T.contiguous()
            esz = a.element_size()
            # the bf16 kernel alone is the launch on B as given (the call
            # adds nothing to it); the float32 one on Bt, split per call
            kern = (lambda a=a, b=b: _matmul_float(a, b, True)) \
                if dt == bf16 else (lambda a=a, bt=bt: matmul_float(a, bt))
            timed("matmul_pallas", f"{str(dt)[6:]} mode: ({m}, {k}) @ "
                  f"({k}, {n}) -> f32",
                  "matmul_bf16.cu" if dt == bf16 else "matmul.cu",
                  "mamimo_tpu/ops/pallas/int8_mm.py:50", kern,
                  lambda a=a, b=b: _matmul_float_plain(a, b),
                  lambda a=a, b=b: torch.matmul(a, b),
                  (m * k + k * n) * esz + m * n * 4, 2.0 * m * n * k, peak,
                  mm_launches[dt],
                  "phase 5m's checks (no path of the port multiplies bf16 "
                  "or float32 through kernel 6)",
                  errs[f"matmul_pallas {str(dt)[6:]} {m}"],
                  call=lambda a=a, b=b: matmul_pallas(a, b))
            if dt == bf16:
                # its bf16 store beside torch.matmul's (which stores bf16)
                t_st = time_ms(lambda a=a, b=b: matmul_pallas(
                    a, b, out_dtype=bf16), iters=10)
                t_lib = time_ms(lambda a=a, b=b: torch.matmul(a, b),
                                iters=10)
                print(f"  matmul_pallas [bf16 mode: ({m}, {k}) @ ({k}, {n}) "
                      f"-> bf16]: {t_st:.5f} ms; torch.matmul {t_lib:.5f} "
                      f"ms  [{smi}]")
            del a, b, bt
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"[5m float32 modes] {secs:.1f} s")
    return {"errors": {k: (v if isinstance(v, float) else v["nmse_db"])
                       for k, v in errs.items()},
            "launches": counts, "rows": rows, "seconds": secs}


# phase 5n: the float32 modes of kernels 2 and 5 (dot_dtype=float32) and
# kernel 2's out_dtype
F32_MODELS = ((1024, 1024), (1024,), (1024, 1024, 1024), (2048, 2048))
F32_PACKETS = 16                   # phase 5n: BS32 requests (S = 64)
F32_MLP_ROWS = 256                 # phase 5n: predict_complex_pallas rows


def f32_chain_names(depth: int) -> tuple:
    """Kernel 2's float32 kernels for a model of `depth` hidden layers:
    the per-head rows at every depth (fused_factored_planes' routing of
    float32 weights)."""
    return ("factored_sig_proj f32", "factored_heads f32") \
        + (("factored_dense f32",) if depth != 2 else ()) \
        + (("factored_rows_tail f32",) if depth >= 2 else ())


def dnn_f32_phase(dev, counted, require_launched) -> dict:
    """Phase 5n: BS32 models with float32 weights (hidden F32_MODELS)
    served through predict_all_pairs_planes_kernel, and the two-layer ones
    through predict_complex_pallas(dot_dtype=float32), each counted
    (every float32 kernel of the path launched in its float32 mode) and
    within F32_LIMIT_DB of the float32 plain model (TF32 off), the bf16
    mode's dB on the same weights printed beside; fused_factored_planes
    with out_dtype=bfloat16 exactly the float32 result rounded. Each
    float32 kernel of the chain against its plain version on the same
    inputs at S = S_CHECK, 1, 5, 65 and with 3 heads (ReLU flips of the
    rows counted: a ReLU's 0 leaves exactly the BN shift), kernel 5's at
    S_CHECK·32 − 3, 1 and 65 rows; the bf16 stores of every output
    kernel, both modes, exactly the float32 result rounded. Returns the
    errors, the counts and the checked models' weights for the timing."""
    import torch

    from mamimo_tpu_torch.config import SimConfig, TrainConfig
    from mamimo_tpu_torch.models.mlp import (
        _factored_all_pairs,
        plane,
        predict_complex,
    )
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        _heads_plain,
        _hidden_plain,
        _out_plain,
        _tail_plain,
        factored_dense,
        factored_heads,
        factored_rows_tail,
        factored_sig_proj,
        factored_tail,
        fused_factored_planes,
        predict_all_pairs_planes_kernel,
        prepare_factored_weights,
    )
    from mamimo_tpu_torch.ops.kernels.mlp_infer import (
        _layer1_plain,
        _tail_plain as _mlp_tail_plain,
        mlp_infer_layer1,
        mlp_infer_tail,
        predict_complex_pallas,
        prepare_mlp_infer_weights,
    )
    from mamimo_tpu_torch.ops.kernels.util import (
        _tf32_split_plain,
        tf32_split,
    )
    from mamimo_tpu_torch.ops.ltf import pilot_p_matrix
    from mamimo_tpu_torch.utils.numerics import full_f32_matmul

    f32, bf16 = torch.float32, torch.bfloat16
    t0 = time.perf_counter()
    cfg = SimConfig()
    nt, nr, L, C = cfg.num_tx, cfg.num_rx, cfg.len_ltf, cfg.num_carriers
    g = torch.Generator(device=dev).manual_seed(95)
    errs, counts, served, flips = {}, {}, {}, {}
    print("[5n float32 DNN] float32 weights through kernels 2 and 5; "
          "kernel 2's bf16 store")
    # the split kernel on signs, zeros, subnormals, ties and binade edges,
    # and at a size that fills no block, bit for bit
    e = 2.0 ** -11
    sv = torch.tensor([0.0, -0.0, 1e-40, -1e-40, 1.4e-45, -3e-39, 1 + e,
                       -(1 + e), 1 + 3 * e, -(1 + 3 * e), 2 - 2 ** -23,
                       3.0e38, -1.1754942e-38, 1 + e + 2 ** -23], device=dev)
    for what, t in (("signs, zeros, subnormals and ties", sv),
                    ("(7, 333) randn, dim 1", torch.randn(
                        (7, 333), generator=g, device=dev))):
        dim = t.dim() - 1
        got = tf32_split(t, dim).view(torch.int32)
        if not torch.equal(got, _tf32_split_plain(t, dim).view(torch.int32)):
            raise AssertionError(f"tf32_split of {what}: not its plain "
                                 f"version's bits")
        print(f"  tf32_split of {what}: bit for bit its plain version")

    def db_of(got, ref):
        g64, r64 = got.double(), ref.double()
        if g64.is_complex():
            g64, r64 = torch.view_as_real(g64), torch.view_as_real(r64)
        return 10 * float(torch.log10((g64 - r64).square().sum()
                                      / r64.square().sum()))

    def same(what, got, ref):
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            raise AssertionError(f"{what}: not identical")
        print(f"  {what}: identical")

    def split_check(tag, tree):
        """Each K-major weight's parts in the float32 tree: the split
        kernel's output bit for bit its plain version's on the same
        weight."""
        i32 = torch.int32
        for k in sorted(k for k in tree if k.endswith("_tf32")):
            # the weight K-major, zero-padded to the parts' rows as the
            # tree's K-major weights are
            w = tree[k[:-6]].transpose(-1, -2)
            kt = w.new_zeros((w.shape[0], tree[k].shape[2], w.shape[2]))
            kt[:, :w.shape[1]] = w
            same(f"tf32_split of {k[:-5]}, {tag}: the kernel's parts = its "
                 f"plain version's, bit for bit", tree[k].view(i32),
                 _tf32_split_plain(kt, 1).view(i32))

    def relu_zero_flips(got, ref, c):
        """Rows whose ReLU gave 0 (the value is exactly the BN shift c) in
        one of two runs and not in the other."""
        return int(((got == c) != (ref == c)).sum())

    def chain_check(tag, prep, sp, depth):
        """Kernel 2's float32 chain on sig_proj, each kernel against its
        plain version on the kernel's own input; the bf16 store exactly
        the float32 result rounded. Returns {kernel: check result}."""
        out, fl = {}, []
        with full_f32_matmul():
            h = factored_heads(prep, sp)
            ref = _heads_plain(prep, sp).view(2, -1, sp.shape[2])
            out["factored_heads"] = check(
                f"factored_heads f32, {tag}, vs its plain version", h, ref,
                F32_LIMIT_DB)
            fl.append(relu_zero_flips(h, ref, prep["c1"]))
            for k in range(2, depth):
                hk = factored_dense(prep, k, h)
                ref = _hidden_plain(prep, k, h)
                out["factored_dense"] = check(
                    f"factored_dense f32 layer {k}, {tag}, vs its plain "
                    f"version", hk, ref, F32_LIMIT_DB)
                fl.append(relu_zero_flips(hk, ref, prep[f"c{k}"]))
                h = hk
            if depth == 1:
                y = factored_dense(prep, 2, h, C)
                out["factored_dense out"] = check(
                    f"factored_dense f32 output layer, {tag}, vs its plain "
                    f"version", y, _out_plain(prep, h, C), F32_LIMIT_DB)
                same(f"factored_dense f32 output layer, {tag}: bf16 store "
                     f"= the f32 result rounded",
                     factored_dense(prep, 2, h, C, bf16), y.to(bf16))
            else:
                y = factored_rows_tail(prep, h, C)
                out["factored_rows_tail"] = check(
                    f"factored_rows_tail f32, {tag}, vs its plain version",
                    y, _out_plain(prep, _hidden_plain(prep, depth, h), C),
                    F32_LIMIT_DB)
                same(f"factored_rows_tail f32, {tag}: bf16 store = the f32 "
                     f"result rounded",
                     factored_rows_tail(prep, h, C, bf16), y.to(bf16))
        print(f"    ReLU flips of the rows, kernel vs plain, per layer: "
              f"{fl}")
        flips[tag] = fl
        return out

    for hidden in F32_MODELS:
        t_model = time.perf_counter()
        tcfg = TrainConfig(hidden=hidden)
        depth = len(hidden)
        tag = f"hidden {hidden}"
        params, bn = make_model(cfg, tcfg, seed=80 + depth, device=dev,
                                bf16_values=False)
        with full_f32_matmul():
            # the float32 weights' K-major parts: the split kernel, once
            p32, cnt = counted(lambda: prepare_factored_weights(
                cfg, tcfg, params, bn, dot_dtype=f32))
            p16 = prepare_factored_weights(cfg, tcfg, params, bn)
        require_launched(f"prepare_factored_weights float32, {tag}", cnt,
                         ("tf32_split",))
        prep_counts = {"prepare_factored_weights": cnt}
        split_check(tag, p32)
        # the served path: rx-major float32 planes of F32_PACKETS packets
        rx = torch.randn((2, F32_PACKETS, nr, L), generator=g, device=dev)
        x = rx.reshape(2, -1, L)
        got, cnt = counted(lambda: predict_all_pairs_planes_kernel(
            cfg, tcfg, p32, rx))
        require_launched(f"predict_all_pairs_planes_kernel float32, {tag}",
                         cnt, f32_chain_names(depth))
        if any(cnt[n] for n in ("factored_tail",)):
            raise AssertionError(f"{tag}: a float32 model ran the bf16 fused "
                                 f"tail: {cnt}")
        counts[tag] = {**prep_counts,
                       "predict_all_pairs_planes_kernel": cnt}
        with full_f32_matmul():
            ref_d = _factored_all_pairs(cfg, tcfg, params, bn, x)
        ref = torch.complex(ref_d[0], ref_d[1]).view(got.shape)
        served[tag] = {"all_pairs": check(
            f"[5n] {tag}: predict_all_pairs_planes_kernel float32 "
            f"({F32_PACKETS} packets) vs the f32 factored DNN", got, ref,
            F32_LIMIT_DB)}
        db16 = db_of(predict_all_pairs_planes_kernel(cfg, tcfg, p16, rx), ref)
        served[tag]["all_pairs bf16 mode db"] = db16
        print(f"    (the bf16 mode on the same weights and planes: "
              f"{db16:.2f} dB)")
        y32 = fused_factored_planes(cfg, tcfg, p32, x, dot_dtype=f32)
        same(f"fused_factored_planes float32, {tag}: out_dtype=bfloat16 = "
             f"the f32 result rounded", fused_factored_planes(
                 cfg, tcfg, p32, x, dot_dtype=f32, out_dtype=bf16),
             y32.to(bf16))
        y16 = fused_factored_planes(cfg, tcfg, p16, x.to(bf16))
        same(f"fused_factored_planes bf16, {tag}: out_dtype=bfloat16 = the "
             f"f32 result rounded", fused_factored_planes(
                 cfg, tcfg, p16, x.to(bf16), out_dtype=bf16), y16.to(bf16))
        del got, ref, ref_d, y32, y16
        # each float32 kernel against its plain version: S_CHECK, ragged
        # S, 3 heads
        xs = torch.randn((2, S_CHECK, L), generator=g, device=dev)
        with full_f32_matmul():
            sp = factored_sig_proj(xs, p32["w1"], p32["w1t_tf32"])
            e = {"factored_sig_proj": check(
                f"factored_sig_proj f32, {tag}, S = {S_CHECK}, vs its plain "
                f"version", sp, xs @ p32["w1"], F32_LIMIT_DB)}
            for s_r in (1, 5, 65):
                check(f"factored_sig_proj f32, {tag}, S = {s_r}, vs its "
                      f"plain version", factored_sig_proj(
                          xs[:, :s_r], p32["w1"], p32["w1t_tf32"]),
                      xs[:, :s_r] @ p32["w1"], F32_LIMIT_DB)
        e.update(chain_check(f"{tag}, S = {S_CHECK}", p32, sp, depth))
        for s_r in (1, 5, 65):
            chain_check(f"{tag}, S = {s_r}", p32, sp[:, :s_r].contiguous(),
                        depth)
        p3 = {**p32, "hb": p32["hb"][:, :3].contiguous()}
        chain_check(f"{tag}, 3 heads, S = {S_CHECK}", p3, sp, depth)
        errs[tag] = e
        # the bf16 mode's output stores (kernel 2's out_dtype)
        sp16 = factored_sig_proj(xs.to(bf16), p16["w1"], p16["w1t"])
        if depth == 2 and hidden[0] <= 1024:
            y = factored_tail(p16, sp16, C)
            same(f"factored_tail bf16, {tag}: bf16 store = the f32 result "
                 f"rounded", factored_tail(p16, sp16, C, bf16), y.to(bf16))
            errs[tag]["factored_tail"] = check(
                f"factored_tail bf16, {tag}, vs its plain version", y,
                _tail_plain(p16, sp16, C), -40.0)
        h16 = factored_heads(p16, sp16)
        for k in range(2, depth):
            h16 = factored_dense(p16, k, h16)
        if depth == 1:
            y = factored_dense(p16, 2, h16, C)
            same(f"factored_dense bf16 output layer, {tag}: bf16 store = "
                 f"the f32 result rounded",
                 factored_dense(p16, 2, h16, C, bf16), y.to(bf16))
        else:
            y = factored_rows_tail(p16, h16, C)
            same(f"factored_rows_tail bf16, {tag}: bf16 store = the f32 "
                 f"result rounded", factored_rows_tail(p16, h16, C, bf16),
                 y.to(bf16))
        del sp, sp16, h16, y, xs
        if depth == 2:
            # kernel 5: predict_complex_pallas(dot_dtype=float32), counted
            with full_f32_matmul():
                m32, cnt = counted(lambda: prepare_mlp_infer_weights(
                    tcfg, params, bn, dot_dtype=f32))
                m16 = prepare_mlp_infer_weights(tcfg, params, bn)
            require_launched(f"prepare_mlp_infer_weights float32, {tag}",
                             cnt, ("tf32_split",))
            counts[tag]["prepare_mlp_infer_weights"] = cnt
            split_check(f"{tag}, kernel 5's tree", m32)
            sig = torch.complex(
                torch.randn((F32_MLP_ROWS, L), generator=g, device=dev),
                torch.randn((F32_MLP_ROWS, L), generator=g, device=dev))
            pil = pilot_p_matrix(nt, device=dev).T[
                torch.arange(F32_MLP_ROWS, device=dev) % nt]
            got, cnt = counted(lambda: predict_complex_pallas(
                cfg, tcfg, m32, None, sig, pil, dot_dtype=f32))
            require_launched(f"predict_complex_pallas float32, {tag}", cnt,
                             ("mlp_infer_layer1 f32", "mlp_infer_tail f32"))
            counts[tag]["predict_complex_pallas"] = cnt
            with full_f32_matmul():
                ref = predict_complex(cfg, tcfg, params, bn, sig, pil)
            served[tag]["predict_complex_pallas"] = check(
                f"[5n] {tag}: predict_complex_pallas float32 "
                f"({F32_MLP_ROWS} rows) vs f32 predict_complex", got, ref,
                F32_LIMIT_DB)
            db16 = db_of(predict_complex_pallas(cfg, tcfg, m16, None, sig,
                                                pil), ref)
            served[tag]["predict_complex_pallas bf16 mode db"] = db16
            print(f"    (the bf16 mode on the same weights: {db16:.2f} dB)")
            pm = plane(m32, 1)
            k = L + nt
            xm = torch.randn((S_CHECK * nt - 3, k), generator=g, device=dev)
            with full_f32_matmul():
                for what, xe in ((f"{xm.shape[0]} rows", xm),
                                 ("1 row", xm[:1]), ("65 rows", xm[:65])):
                    h1 = mlp_infer_layer1(pm, xe)
                    ref1 = _layer1_plain(pm, xe, f32)
                    r = check(f"mlp_infer_layer1 f32 ({what}, K = {k}), "
                              f"{tag}, vs its plain version", h1, ref1,
                              F32_LIMIT_DB)
                    errs[tag].setdefault("mlp_infer_layer1", r)
                    fl = relu_zero_flips(h1, ref1, pm["t1"])
                    print(f"    ReLU flips of h1, kernel vs plain: {fl}")
                    r = check(f"mlp_infer_tail f32 ({what}), {tag}, vs its "
                              f"plain version", mlp_infer_tail(pm, h1),
                              _mlp_tail_plain(pm, h1, f32), F32_LIMIT_DB)
                    errs[tag].setdefault("mlp_infer_tail", r)
            del m32, m16, sig, pil, got, ref, xm, h1, ref1
        del params, bn, p32, p16, rx, x
        torch.cuda.empty_cache()
        print(f"  [5n] {tag}: {time.perf_counter() - t_model:.1f} s")
    secs = time.perf_counter() - t0
    print(f"[5n float32 DNN] {len(F32_MODELS)} models; {secs:.1f} s")
    return {"served_nmse_db": {k: {n: (v if isinstance(v, float)
                                       else v["nmse_db"])
                                   for n, v in d.items()}
                               for k, d in served.items()},
            "errors": errs, "relu_flips": flips, "launches": counts,
            "seconds": secs}


def dnn_f32_timing(dev, smi, res) -> list:
    """Phase 6's rows of the float32 DNN kernels (phase 5n): each at the
    bench shape (S = 4096, BS32, hidden (1024, 1024); the depth-3 model's
    hidden layer and the depth-1 model's output layer for factored_dense;
    kernel 5 on one plane's 131072 rows) beside its plain version (TF32
    off), its bound (float32 bytes once, products once at the TF32 peak)
    and a float32 torch.matmul / bmm yardstick (TF32 off); the bf16 fused
    tail with its bf16 store beside the float32 one. Returns the rows of
    the kernels line."""
    import torch

    from mamimo_tpu_torch.config import SimConfig, TrainConfig
    from mamimo_tpu_torch.models.mlp import plane
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        _heads_plain,
        _hidden_plain,
        _out_plain,
        _tail_plain,
        factored_dense,
        factored_heads,
        factored_rows_tail,
        factored_sig_proj,
        factored_tail,
        prepare_factored_weights,
    )
    from mamimo_tpu_torch.ops.kernels.mlp_infer import (
        _layer1_plain,
        _tail_plain as _mlp_tail_plain,
        mlp_infer_layer1,
        mlp_infer_tail,
        prepare_mlp_infer_weights,
    )
    from mamimo_tpu_torch.ops.kernels.util import (
        _tf32_split_plain,
        tf32_split,
    )
    from mamimo_tpu_torch.utils.numerics import full_f32_matmul

    f32, bf16 = torch.float32, torch.bfloat16
    cfg = SimConfig()
    nt, nr, L, C = cfg.num_tx, cfg.num_rx, cfg.len_ltf, cfg.num_carriers
    S = BENCH_PACKETS * nr
    M = S * nt
    g = torch.Generator(device=dev).manual_seed(96)
    rows = []
    nbytes_of = lambda *ts: sum(t.numel() * t.element_size()  # noqa: E731
                                for t in ts)
    ff_src = "mamimo_tpu/ops/pallas/fused_factored.py:169"
    mlp_src = "mamimo_tpu/ops/pallas/mlp_infer.py:144"

    def timed(name, shape, src, repl, kern, plain, lib, nbytes, ops,
              launches, path, err, peak=TF32_FLOPS):
        ms = time_ms(kern, iters=5, warmup=2)
        with full_f32_matmul():
            plain_ms = time_ms(plain, iters=2, warmup=1)
            lib_ms = time_ms(lib, iters=3, warmup=1) if lib else None
        bms, by = bound_ms(nbytes, ops, peak)
        print(f"  {name} [{shape}]: {ms:.5f} ms (bound {bms:.5f} ms by {by},"
              f" {bms / ms * 100:.1f}% of it); plain {plain_ms:.4f} ms; "
              f"library {'none' if lib_ms is None else f'{lib_ms:.4f} ms'}"
              f"  [{smi}]")
        rows.append({"name": name, "shape": shape, "route": "cuda",
                     "source": f"mamimo_tpu_torch/csrc/{src}",
                     "replaces": repl, "launches": launches,
                     "launches_in": path, "max_abs_err": err["max_abs_err"],
                     "nmse_db": err["nmse_db"], "exact": False, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
                     "library_ms": lib_ms, "call_ms": None,
                     "ms_from": "events", "call_ms_from": "events"})

    def model(hidden, seed):
        tcfg = TrainConfig(hidden=hidden)
        params, bn = make_model(cfg, tcfg, seed=seed, device=dev,
                                bf16_values=False)
        with full_f32_matmul():
            return tcfg, params, bn, prepare_factored_weights(
                cfg, tcfg, params, bn, dot_dtype=f32)

    def relu_affine(p, k, y):
        return torch.relu(y + p[f"b{k}"]) * p[f"a{k}"] + p[f"c{k}"]

    print(f"  float32 DNN kernels at S = {S} ({M} rows a plane)")
    by_depth = {len(hd): hd for hd in reversed(F32_MODELS)}
    tag = f"hidden {by_depth[2]}"
    cnt = res["launches"][tag]["predict_all_pairs_planes_kernel"]
    path = f"predict_all_pairs_planes_kernel x1 float32, {tag} (5n)"
    tcfg, params, bn, p = model(by_depth[2], 82)
    H = p["w1"].shape[2]
    x = torch.randn((2, S, L), generator=g, device=dev)
    e = res["errors"][tag]
    timed("factored_sig_proj", f"float32 mode: (2, {S}, {L}) @ (2, {L}, {H})"
          f" f32 -> f32", "fused_factored.cu", ff_src,
          lambda: factored_sig_proj(x, p["w1"], p["w1t_tf32"]),
          lambda: x @ p["w1"], lambda: torch.bmm(x, p["w1"]),
          nbytes_of(x, p["w1"]) + 2 * S * H * 4, 2.0 * 2 * S * L * H,
          cnt["factored_sig_proj f32"], path, e["factored_sig_proj"])
    with full_f32_matmul():
        sp = factored_sig_proj(x, p["w1"], p["w1t_tf32"])
    del x
    h = factored_heads(p, sp)
    timed("factored_heads", f"float32 mode: sig_proj (2, {S}, {H}) f32 -> "
          f"rows (2, {M}, {H}) f32", "fused_factored.cu", ff_src,
          lambda: factored_heads(p, sp), lambda: _heads_plain(p, sp), None,
          nbytes_of(sp, p["hb"], p["a1"], p["c1"], h), 0.0,
          cnt["factored_heads f32"], path, e["factored_heads"])
    o = 3
    H2 = p["w2"].shape[2]
    timed("factored_rows_tail", f"float32 mode, {tag}: rows (2, {M}, {H}) "
          f"f32 -> (2, {M}, {C}) f32", "fused_factored.cu", ff_src,
          lambda: factored_rows_tail(p, h, C),
          lambda: _out_plain(p, _hidden_plain(p, 2, h), C),
          lambda: torch.bmm(relu_affine(p, 2, torch.bmm(h, p["w2"])),
                            p["w3"])[..., :C],
          nbytes_of(h, p["w2"], p["b2"], p["a2"], p["c2"], p[f"w{o}"],
                    p[f"b{o}"]) + 2 * M * C * 4,
          2.0 * 2 * M * (H * H2 + H2 * C), cnt["factored_rows_tail f32"],
          path, e["factored_rows_tail"])
    del sp, h
    # kernel 2's bf16 store: the fused tail of the bf16 model
    with full_f32_matmul():
        p16 = prepare_factored_weights(cfg, tcfg, params, bn)
    sp16 = torch.randn((2, S, H), generator=g, device=dev) * 0.5
    ms32 = time_ms(lambda: factored_tail(p16, sp16, C), iters=10)
    ms16 = time_ms(lambda: factored_tail(p16, sp16, C, bf16), iters=10)

    def tail_lib16():
        """The fused tail's function in PyTorch calls (bmm in bf16), bf16
        out."""
        h = _heads_plain(p16, sp16).reshape(2, -1, H).to(bf16)
        h2 = (torch.relu(torch.bmm(h, p16["w2"]).float() + p16["b2"])
              * p16["a2"] + p16["c2"]).to(bf16)
        return (torch.bmm(h2, p16["w3"]).float() + p16["b3"])[..., :C].to(
            bf16)

    plain16 = time_ms(lambda: _tail_plain(p16, sp16, C, bf16), iters=2,
                      warmup=1)
    lib16 = time_ms(tail_lib16, iters=3, warmup=1)
    print(f"  factored_tail bf16 weights, S = {S}: f32 store {ms32:.5f} ms, "
          f"bf16 store {ms16:.5f} ms; the bf16 store's plain version "
          f"{plain16:.4f} ms, library (bmm chain, bf16 out) {lib16:.4f} ms"
          f"  [{smi}]")
    # the bf16 layer-1 GEMM and rows tail at the same shapes, in the same
    # window as the float32 rows
    x16 = torch.randn((2, S, L), generator=g, device=dev).to(bf16)
    h16 = torch.relu(torch.randn((2, M, H), generator=g, device=dev)).to(
        bf16)
    t_sp = time_ms(lambda: factored_sig_proj(x16, p16["w1"], p16["w1t"]),
                   iters=10)
    t_rt = time_ms(lambda: factored_rows_tail(p16, h16, C), iters=5)
    print(f"  beside them, bf16: factored_sig_proj {t_sp:.5f} ms, "
          f"factored_rows_tail {t_rt:.5f} ms  [{smi}]")
    del p16, sp16, x16, h16
    # kernel 5 on one plane's materialized rows
    with full_f32_matmul():
        pm = plane(prepare_mlp_infer_weights(tcfg, params, bn,
                                             dot_dtype=f32), 0)
        pm16 = plane(prepare_mlp_infer_weights(tcfg, params, bn), 0)
    del params, bn, p
    torch.cuda.empty_cache()
    cnt5 = res["launches"][tag]["predict_complex_pallas"]
    path5 = f"predict_complex_pallas x1 float32, {tag} (5n)"
    K = L + nt
    xm = torch.randn((M, K), generator=g, device=dev)
    timed("mlp_infer_layer1", f"float32 mode: ({M}, {K}) @ ({K}, {H}) f32 "
          f"-> f32, one plane", "mlp_infer.cu", mlp_src,
          lambda: mlp_infer_layer1(pm, xm),
          lambda: _layer1_plain(pm, xm, f32),
          lambda: torch.matmul(xm, pm["w1"][:K]),
          nbytes_of(xm, pm["w1"]) + M * H * 4, 2.0 * M * K * H,
          cnt5["mlp_infer_layer1 f32"], path5, e["mlp_infer_layer1"])
    with full_f32_matmul():
        h1 = mlp_infer_layer1(pm, xm)
    del xm
    torch.cuda.empty_cache()
    w3c = pm["w3"][:, :C]
    timed("mlp_infer_tail", f"float32 mode: h1 ({M}, {H}) f32 -> ({M}, {C})"
          f" f32", "mlp_infer.cu", mlp_src,
          lambda: mlp_infer_tail(pm, h1),
          lambda: _mlp_tail_plain(pm, h1, f32),
          lambda: torch.matmul(torch.relu(torch.matmul(h1, pm["w2"])
                                          + pm["b2"]) * pm["s2"] + pm["t2"],
                               w3c) + pm["b3"],
          nbytes_of(h1, pm["w2"], pm["b2"], pm["s2"], pm["t2"], w3c,
                    pm["b3"]) + M * C * 4,
          2.0 * M * (H * pm["w2"].shape[1] + pm["w2"].shape[1] * C),
          cnt5["mlp_infer_tail f32"], path5, e["mlp_infer_tail"])
    # the split kernel on kernel 5's widest weight, W1 K-major
    w1t = pm["w1"].T.contiguous()
    cnt_split = res["launches"][tag]["prepare_factored_weights"]
    timed("tf32_split", f"w1t ({w1t.shape[0]}, {w1t.shape[1]}) f32 -> its "
          f"TF32 parts (2, {w1t.shape[0]}, {w1t.shape[1]}) f32",
          "tf32_split.cu", None, lambda: tf32_split(w1t),
          lambda: _tf32_split_plain(w1t), None, 3 * nbytes_of(w1t), 0.0,
          cnt_split["tf32_split"],
          f"prepare_factored_weights(dot_dtype=float32) x1, {tag} (5n)",
          {"max_abs_err": 0.0, "nmse_db": None})
    rows[-1]["exact"] = True
    rows[-1]["note"] = ("splits the float32 weights of kernels 2, 5 and 6 "
                        "(their float32 modes) once; no TPU kernel of its "
                        "own")
    # the bf16 layer-1 GEMM and tail of kernel 5 beside the float32 ones
    xm16 = torch.randn((M, K), generator=g, device=dev).to(bf16)
    t_l1 = time_ms(lambda: mlp_infer_layer1(pm16, xm16), iters=5)
    h116 = mlp_infer_layer1(pm16, xm16)
    del xm16
    t_tl = time_ms(lambda: mlp_infer_tail(pm16, h116), iters=10)
    print(f"  beside them, bf16: mlp_infer_layer1 {t_l1:.5f} ms, "
          f"mlp_infer_tail {t_tl:.5f} ms  [{smi}]")
    del h1, pm, pm16, h116
    torch.cuda.empty_cache()
    # factored_dense: the depth-3 model's hidden layer, the depth-1
    # model's output layer
    for hidden, seed, k in ((by_depth[3], 83, 2), (by_depth[1], 81, 2)):
        tg = f"hidden {hidden}"
        cnt_d = res["launches"][tg]["predict_all_pairs_planes_kernel"]
        tcfg, params, bn, p = model(hidden, seed)
        h = torch.relu(torch.randn((2, M, H), generator=g, device=dev))
        out_layer = len(hidden) == 1
        kout = C if out_layer else p[f"w{k}"].shape[2]
        name = "output layer" if out_layer else f"layer {k}"
        err = res["errors"][tg]["factored_dense out" if out_layer
                                else "factored_dense"]
        timed("factored_dense", f"float32 mode, {tg}, {name}: rows (2, {M}, "
              f"{H}) f32 -> (2, {M}, {kout}) f32", "fused_factored.cu",
              ff_src,
              (lambda: factored_dense(p, k, h, C)) if out_layer
              else (lambda: factored_dense(p, k, h)),
              (lambda: _out_plain(p, h, C)) if out_layer
              else (lambda: _hidden_plain(p, k, h)),
              (lambda: torch.bmm(h, p["w2"])[..., :C] + p["b2"][..., :C])
              if out_layer else
              (lambda: relu_affine(p, k, torch.bmm(h, p[f"w{k}"]))),
              nbytes_of(h, p[f"w{k}"], p[f"b{k}"]) + 2 * M * kout * 4
              + (0 if out_layer else nbytes_of(p[f"a{k}"], p[f"c{k}"])),
              2.0 * 2 * M * H * kout, cnt_d["factored_dense f32"],
              f"predict_all_pairs_planes_kernel x1 float32, {tg} (5n)", err)
        del params, bn, p, h
        torch.cuda.empty_cache()
    return rows


# phase 5o: kernels 1, 3 and 4 at every num_tx and cp_length a JAX
# configuration takes (tag: num_tx, num_rx, cp_length, packets checked)
SHAPE_CFGS = {"Nt 512": (512, 4, 64, 128),          # S = 512
              "Nt 1024": (1024, 4, 64, 32),         # S = 128
              "BS32 cp 18": (32, 4, 18, 64),        # NR's normal CP at FFT 256
              "BS32 cp 9": (32, 4, 9, 64)}
SHAPE_BIG_PACKETS = 1024           # one Nt 1024 call, S = 4096 (2.68e9 input)
SHAPE_SHARDED_PACKETS = 16         # the sharded LS at Nt 1024 (S = 64)
SHAPE_MODEL = (1024, 1024)         # the model served at the new shapes
SHAPE_TIMED = {"Nt 512": 512, "Nt 1024": 128, "BS32 cp 18": 4096}  # S
# the widths whose LS kernels read the part transform (4 and 8 parts a
# sample): kernels 1, 3 and 4 within (bf16, bf16 stored in bf16,
# float32) dB of their float32 plain versions (one more bf16 rounding,
# that of the transform's output, than the -57.75 dB of the aligned
# bodies, about -53.5 dB; a bf16 store adds its own, about -51.4 dB;
# one K = 512 sum a tile in float32)
PARTS_LIMITS_DB = {"Nt 512": (-52.0, -50.0, -100.0),
                   "Nt 1024": (-52.0, -50.0, -100.0)}
# Nt 2048 (16 parts) served at 2 packets by a (128, 128) model: its layer
# 1 has K = 655360, a 0.67 GB float32 W1
SHAPE_2048 = (2048, 4, 64, 2)
SHAPE_2048_MODEL = (128, 128)
# layer 1 split across the card: (S, num_tx) of each check and timed row,
# and its limit against float32 x @ W1 (each range one accumulator over
# K / splits: -98.97 dB at K = 10240, 6 dB a doubling)
SPLIT_SHAPES = {"Nt 1024": (128, 1024), "Nt 512": (512, 512)}
SPLIT_LIMIT_DB = -85.0


def shape_cfg(tag):
    from mamimo_tpu_torch.config import SimConfig

    nt, nr, cp, _ = SHAPE_CFGS[tag]
    return SimConfig(num_tx=nt, num_rx=nr, cp_length=cp)


def ls_shapes_phase(dev, counted, require_launched) -> dict:
    """Phase 5o: kernels 1, 3 and 4 at the shapes of SHAPE_CFGS (four and
    eight 128-symbol parts a sample, map rows of four and eight symbols),
    each against its plain version on the same planes: kernel 1 bf16
    (f32 store; bf16 store and sums of h^2, check_v2_modes) and float32
    (its bf16 store exactly the float32 result rounded, its sums), at S
    odd too, seq ranks of 2 and 4 whose bf16 partials sum to the
    estimate; kernel 3 raw (f32 and bf16 out), complex and as_planes in
    both modes; kernel 4 on bf16 pair planes and complex64 rx. Limits:
    bf16 -45 dB, float32 F32_LIMIT_DB (at the widths of PARTS_LIMITS_DB
    its tighter limits, after the part transform held bit for bit to its
    plain version). Then sharded_ls_pallas_v2 at Nt 1024 (seq 2, seq 4,
    data 4 on 4 virtual ranks), estimate_full with a SHAPE_MODEL model at
    Nt 512, Nt 1024 and BS32 cp 18 and a SHAPE_2048_MODEL one at Nt 2048
    against the float32 path (PIPE_LIMITS), kernel 2 at Nt 1024 (fused
    tail and per-head rows in bf16, the float32 rows route; the float32
    layer 1 timed), layer 1 split across the card at SPLIT_SHAPES and
    unsplit at BS32's bench shape, and one Nt 1024 call at
    SHAPE_BIG_PACKETS packets whose last 8 samples are held to the plain
    version run on them alone. Every group counted. Returns the errors,
    the counts and the timing's inputs."""
    import torch

    from mamimo_tpu_torch.bench import _planes_to_time_major
    from mamimo_tpu_torch.config import SimConfig, TrainConfig
    from mamimo_tpu_torch.models.mlp import _factored_all_pairs
    from mamimo_tpu_torch.models.predictor import CSIPredictor
    from mamimo_tpu_torch.ops.estimate import (
        ls_estimate_matmul,
        ls_estimate_planes,
        ls_planes_constants,
    )
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        _heads_plain,
        _hidden_plain,
        _out_plain,
        factored_heads,
        factored_rows_tail,
        factored_sig_proj,
        fused_factored_planes,
        prepare_factored_weights,
        sig_proj_splits,
    )
    from mamimo_tpu_torch.ops.kernels.fused_ls import (
        _ls_parts_plain,
        _ls_v1_plain,
        _ls_v2_plain,
        _ssq_plain,
        ls_estimate_pallas,
        ls_pair_kernel,
        ls_parts,
        ls_planes_pallas,
        ls_planes_v1,
        ls_planes_v2,
        ls_raw_to_complex,
        ls_sm90_constants,
        pair_planes,
    )
    from mamimo_tpu_torch.ops.kernels.util import tf32_split
    from mamimo_tpu_torch.parallel.mesh import make_mesh
    from mamimo_tpu_torch.parallel.sharded import sharded_ls_pallas_v2
    from mamimo_tpu_torch.train.ckpt import save_checkpoint
    from mamimo_tpu_torch.utils.numerics import full_f32_matmul

    f32, bf16 = torch.float32, torch.bfloat16
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(97)
    errs, counts, served = {}, {}, {}
    print("[5o LS shapes] kernels 1, 3 and 4 at Nt 512 and 1024 and at "
          "cyclic prefixes of 18 and 9 samples")

    def same(what, got, ref):
        if got.dtype != ref.dtype or not torch.equal(got, ref):
            raise AssertionError(f"{what}: not identical")
        print(f"  {what}: identical")

    def sums_ok(what, q, ref, loc):
        sref = _ssq_plain(ref, loc)
        rel = float(((q - sref).abs() / sref.abs().clamp_min(1e-30)).max())
        print(f"  {what}: sums {tuple(q.shape)}, max rel err per tile "
              f"{rel:.3e} (limit 1e-4)")
        if q.shape != sref.shape or not rel <= 1e-4:
            raise AssertionError(f"{what}: sums off by {rel:.3e}")

    def ls_checks(tag):
        cfg = shape_cfg(tag)
        nt, nr, L, C = cfg.num_tx, cfg.num_rx, cfg.len_ltf, cfg.num_carriers
        packets = SHAPE_CFGS[tag][3]
        s = packets * nr
        # the limits: tighter where the part transform runs
        lim16, lim16_store, lim32 = PARTS_LIMITS_DB.get(
            tag, (-45.0, -45.0, F32_LIMIT_DB))
        k16, k32 = ls_sm90_constants(cfg, dev), ls_sm90_constants(cfg, dev,
                                                                 f32)
        x32 = torch.randn((2, s, L), generator=g, device=dev)
        x16 = x32.to(bf16)
        r16, r32 = _ls_v2_plain(cfg, x16.float()), _ls_v2_plain(cfg, x32)
        e = errs[tag] = {}
        if tag in PARTS_LIMITS_DB:
            # the part transform bit for bit, full mode and a seq rank of
            # 2 (at Nt 1024: 512 symbols, four parts)
            for xa in (x16, x32):
                same(f"ls_parts {str(xa.dtype)[6:]}, {tag}, S = {s}: the "
                     f"plain version", ls_parts(cfg, xa),
                     _ls_parts_plain(cfg, xa, nt))
                if nt // 2 >= 512:
                    xq = xa[:, :, L // 2:].contiguous()
                    same(f"ls_parts {str(xa.dtype)[6:]}, {tag}, seq rank 1 "
                         f"of 2", ls_parts(cfg, xq, nt // 2),
                         _ls_parts_plain(cfg, xq, nt // 2))
        e["ls_planes_v2"] = check(
            f"ls_planes_v2 bf16, {tag}, S = {s}, vs its plain version (f32)",
            ls_planes_v2(cfg, x16, k16), r16, lim16)
        e["ls_planes_v2 bf16 ssq"] = check_v2_modes(
            cfg, x16, k16, f"{tag}, S = {s}")[(bf16, True)]
        h = ls_planes_v2(cfg, x32, k32)
        e["ls_planes_v2 f32"] = check(
            f"ls_planes_v2 float32, {tag}, S = {s}, vs its plain version "
            f"(f32)", h, r32, lim32)
        same(f"ls_planes_v2 float32, {tag}: bf16 store = the f32 result "
             f"rounded", ls_planes_v2(cfg, x32, k32, out_dtype=bf16),
             h.to(bf16))
        sums_ok(f"ls_planes_v2 float32 + sums, {tag}", ls_planes_v2(
            cfg, x32, k32, with_ssq=True)[1], r32, nt)
        for so in (5, 1):
            check(f"ls_planes_v2 bf16, {tag}, S = {so}", ls_planes_v2(
                cfg, x16[:, :so], k16), r16[:, :so], lim16)
            check(f"ls_planes_v2 float32, {tag}, S = {so}", ls_planes_v2(
                cfg, x32[:, :so], k32), r32[:, :so], lim32)
        for n in (2, 4):
            w = nt // n * cfg.sym_len
            parts = []
            for i in range(n):
                xq16 = x16[:, :, i * w:(i + 1) * w].contiguous()
                parts.append(ls_planes_v2(cfg, xq16, k16, seq_shard=(i, n)))
                if i in (1, n - 1):
                    check(f"ls_planes_v2 bf16, {tag}, seq rank {i} of {n}",
                          parts[-1], _ls_v2_plain(cfg, xq16.float(), (i, n)),
                          lim16)
                    xq32 = x32[:, :, i * w:(i + 1) * w].contiguous()
                    rq = _ls_v2_plain(cfg, xq32, (i, n))
                    hq, q = ls_planes_v2(cfg, xq32, k32, seq_shard=(i, n),
                                         with_ssq=True)
                    check(f"ls_planes_v2 float32, {tag}, seq rank {i} of {n}",
                          hq, rq, lim32)
                    sums_ok(f"ls_planes_v2 float32 + sums, {tag}, seq rank "
                            f"{i} of {n}", q, rq, nt // n)
            check(f"ls_planes_v2 bf16, {tag}: the {n} seq partials summed vs "
                  f"the plain estimate", sum(parts), r16, lim16)
            if n == 2:
                check_v2_modes(cfg, x16[:, :, w:].contiguous(), k16,
                               f"{tag}, S = {s}", (1, 2))
            del parts
        # kernel 3: raw, complex, as_planes
        raw16 = torch.stack(_ls_v1_plain(cfg, x16, 8, f32))
        for dt in (f32, bf16):
            hr, hi = ls_planes_v1(cfg, x16, k16, out_dtype=dt)
            check_pads_zero("ls_planes_v1", hr, hi, s, nt, C)
            e.setdefault("ls_planes_v1", check(
                f"ls_planes_v1 bf16 planes, raw {str(dt)[6:]}, {tag}, vs its "
                f"plain version (f32), pads zero", torch.stack([hr, hi]),
                raw16, lim16 if dt == f32 else lim16_store))
        check(f"ls_planes_v1 bf16 planes, {tag}, S = 3", torch.stack(
            ls_planes_v1(cfg, x16[:, :3], k16)), torch.stack(_ls_v1_plain(
                cfg, x16[:, :3], 8, f32)), lim16)
        raw32 = torch.stack(_ls_v1_plain(cfg, x32, 8, f32))
        hr, hi = ls_planes_v1(cfg, x32, k32)
        check_pads_zero("ls_planes_v1 float32", hr, hi, s, nt, C)
        e["ls_planes_v1 f32"] = check(
            f"ls_planes_v1 float32 raw, {tag}, vs its plain version (f32), "
            f"pads zero", torch.stack([hr, hi]), raw32, lim32)
        check(f"ls_planes_v1 float32, {tag}, S = 3", torch.stack(
            ls_planes_v1(cfg, x32[:, :3], k32)), torch.stack(_ls_v1_plain(
                cfg, x32[:, :3], 8, f32)), lim32)
        check(f"ls_planes_pallas float32 complex, {tag}", ls_planes_pallas(
            cfg, x32, k32), ls_raw_to_complex(cfg, raw32[0], raw32[1], s),
            lim32)
        for xa, ka, dt in ((x32, k32, "float32"), (x16, k16, "bf16")):
            ap = ls_planes_pallas(cfg, xa, ka, as_planes=True)
            same(f"ls_planes_pallas {dt} as_planes, {tag}: the complex form",
                 torch.complex(ap[0], ap[1]), ls_planes_pallas(cfg, xa, ka))
        del raw16, raw32, hr, hi
        # kernel 4: bf16 pair planes and complex64 rx (the float32 mode)
        pk = min(packets, 32)
        for xa, tg in ((x16.float(), "bf16"), (x32, "f32")):
            rx = _planes_to_time_major(xa[:, :pk * nr], nr)
            with full_f32_matmul():
                ref = ls_estimate_matmul(cfg, rx)
            if tg == "bf16":
                e["ls_pair_kernel"] = check(
                    f"ls_pair_kernel bf16 pair planes, {tag}, {pk} packets, "
                    f"vs ls_estimate_matmul (f32)", ls_pair_kernel(
                        cfg, pair_planes(rx), nr, k16), ref, lim16)
            else:
                e["ls_pair_kernel f32"] = check(
                    f"ls_estimate_pallas complex64, {tag}, {pk} packets, vs "
                    f"ls_estimate_matmul (f32)", ls_estimate_pallas(
                        cfg, rx, consts=k32), ref, lim32)
                check(f"ls_estimate_pallas complex64, {tag}, 1 packet",
                      ls_estimate_pallas(cfg, rx[:1], consts=k32), ref[:1],
                      lim32)
        del x16, x32, r16, r32
        torch.cuda.empty_cache()

    names = ("ls_planes_v2", "ls_planes_v2 f32", "ls_planes_v1",
             "ls_planes_v1 f32", "ls_pair_kernel", "ls_pair_kernel f32")
    for tag in SHAPE_CFGS:
        t1 = time.perf_counter()
        _, counts[tag] = counted(lambda: ls_checks(tag))
        require_launched(f"phase 5o's checks, {tag}", counts[tag], names
                         + (("ls_parts",) if tag in PARTS_LIMITS_DB else ()))
        print(f"  [5o] {tag}: {time.perf_counter() - t1:.1f} s")

    # the sharded LS at Nt 1024 on 4 virtual ranks of this card
    cfg = shape_cfg("Nt 1024")
    k16 = ls_sm90_constants(cfg, dev)
    s = SHAPE_SHARDED_PACKETS * cfg.num_rx
    x16 = torch.randn((2, s, cfg.len_ltf), generator=g, device=dev).to(bf16)
    ref = _ls_v2_plain(cfg, x16.float())
    ref = torch.complex(ref[0], ref[1])
    for mode, n in (("seq", 2), ("seq", 4), ("data", 4)):
        m = make_mesh({mode: n}, devices=[dev] * n)
        h, cnt = counted(lambda: sharded_ls_pallas_v2(cfg, m, x16, mode=mode,
                                                     consts=k16))
        errs[f"sharded {mode} {n}"] = check(
            f"sharded_ls_pallas_v2 {mode} {n}, Nt 1024, S = {s}, vs the "
            f"unsharded plain LS", h, ref, -45.0)
        if cnt["ls_planes_v2"] != n:
            raise AssertionError(f"sharded_ls_pallas_v2 {mode} {n}: {cnt}")
        counts[f"sharded_ls_pallas_v2 {mode} {n}"] = cnt
    del x16, ref

    # the serving call at Nt 512, 1024 and 2048 and BS32 cp 18, counted,
    # against the float32 path (the CPU's functions, in full float32 on
    # the card)
    for tag in ("Nt 512", "Nt 1024", "Nt 2048", "BS32 cp 18"):
        if tag == "Nt 2048":
            nt_, nr_, cp_, packets = SHAPE_2048
            cfg = SimConfig(num_tx=nt_, num_rx=nr_, cp_length=cp_)
            tcfg = TrainConfig(hidden=SHAPE_2048_MODEL)
        else:
            cfg, packets = shape_cfg(tag), SHAPE_CFGS[tag][3]
            tcfg = TrainConfig(hidden=SHAPE_MODEL)
        params, bn = make_model(cfg, tcfg, seed=98, device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            save_checkpoint(str(Path(tmp) / "best"), cfg, tcfg, params, bn)
            pred = CSIPredictor(tmp, device=dev)
        req = torch.randn((2, packets * cfg.num_rx, cfg.len_ltf),
                          generator=torch.Generator().manual_seed(99)).numpy()
        (h_ls, h_dnn), cnt = counted(lambda: pred.estimate_full(req))
        require_launched(f"estimate_full, {tag}", cnt, (
            "ls_planes_v2", "factored_sig_proj", "factored_tail")
            + (("ls_parts", "factored_sig_proj split")
               if cfg.num_tx >= 512 else ()))
        counts[f"estimate_full {tag}"] = cnt
        x0 = torch.from_numpy(req).to(dev)
        ref_ls = ls_estimate_planes(cfg, x0, ls_planes_constants(
            cfg, device=dev))
        with full_f32_matmul():
            d = _factored_all_pairs(cfg, tcfg, params, bn, x0)
        on = lambda a: torch.from_numpy(a).to(dev)       # noqa: E731
        served[tag] = {
            "h_ls": check(f"[5o] {tag}: estimate_full h_ls ({packets} "
                          f"packets) vs the f32 LS", on(h_ls), ref_ls,
                          PIPE_LIMITS["served_ls_db"]),
            "h_dnn": check(f"[5o] {tag}: estimate_full h_dnn vs the f32 "
                           f"factored DNN", on(h_dnn), torch.complex(
                               d[0], d[1]), PIPE_LIMITS["served_dnn_db"])}
        del pred, params, bn, x0, ref_ls, d, h_ls, h_dnn
        torch.cuda.empty_cache()

    # kernel 2 at Nt 1024: the fused tail and the per-head rows route in
    # bf16, the float32 rows route, counted
    tcfg = TrainConfig(hidden=SHAPE_MODEL)
    cfg = shape_cfg("Nt 1024")
    C = cfg.num_carriers
    params, bn = make_model(cfg, tcfg, seed=100, device=dev)
    x32 = torch.randn((2, SHAPE_CFGS["Nt 1024"][3] * cfg.num_rx,
                       cfg.len_ltf), generator=g, device=dev)
    x16 = x32.to(bf16)
    with full_f32_matmul():
        prep = prepare_factored_weights(cfg, tcfg, params, bn)
        prep32 = prepare_factored_weights(cfg, tcfg, params, bn,
                                          dot_dtype=f32)
        ref16 = _factored_all_pairs(cfg, tcfg, params, bn, x16.float())
        ref32 = _factored_all_pairs(cfg, tcfg, params, bn, x32)
    y, cnt = counted(lambda: fused_factored_planes(cfg, tcfg, prep, x16))
    require_launched("fused_factored_planes bf16, Nt 1024", cnt,
                     ("factored_sig_proj", "factored_tail"))
    errs["fused_factored_planes Nt 1024"] = check(
        "fused_factored_planes bf16 (fused tail), Nt 1024, vs f32 "
        "_factored_all_pairs", y, ref16, -40.0)
    counts["fused_factored_planes Nt 1024"] = cnt

    def rows_route():
        sp = factored_sig_proj(x16, prep["w1"], prep["w1t"])
        hrows = factored_heads(prep, sp)
        check("factored_heads, Nt 1024, vs its plain version", hrows,
              _heads_plain(prep, sp).view(2, -1, sp.shape[2]), -40.0)
        return hrows, factored_rows_tail(prep, hrows, C)

    (hrows, y), cnt = counted(rows_route)
    require_launched("the per-head rows route bf16, Nt 1024", cnt,
                     ("factored_heads", "factored_rows_tail",
                      "factored_rows_tail gemms"))
    errs["factored_rows_tail Nt 1024"] = check(
        "factored_rows_tail, Nt 1024, vs its plain version", y,
        _out_plain(prep, _hidden_plain(prep, 2, hrows), C), -40.0)
    del hrows
    del params, bn, prep, x16, ref16
    # the float32 rows route at Nt 1024 (S = 128, layer 1 split in one-block
    # units) and at Nt 512 (S = 512, M-tile pairs), counted
    names32 = ("factored_sig_proj f32", "factored_sig_proj split f32",
               "factored_heads f32", "factored_rows_tail f32")
    for tag in ("Nt 1024", "Nt 512"):
        if tag == "Nt 512":
            cfg = shape_cfg(tag)
            params, bn = make_model(cfg, tcfg, seed=101, device=dev)
            x32 = torch.randn((2, SPLIT_SHAPES[tag][0], cfg.len_ltf),
                              generator=g, device=dev)
            with full_f32_matmul():
                prep32 = prepare_factored_weights(cfg, tcfg, params, bn,
                                                  dot_dtype=f32)
                ref32 = _factored_all_pairs(cfg, tcfg, params, bn, x32)
            del params, bn
        y, cnt = counted(lambda: fused_factored_planes(
            cfg, tcfg, prep32, x32, dot_dtype=f32))
        require_launched(f"fused_factored_planes float32, {tag}", cnt,
                         names32)
        errs[f"fused_factored_planes f32 {tag}"] = check(
            f"fused_factored_planes float32 (rows route), {tag}, S = "
            f"{x32.shape[1]}, vs f32 _factored_all_pairs", y, ref32,
            F32_LIMIT_DB)
        counts[f"fused_factored_planes f32 {tag}"] = cnt
        del prep32, x32, ref32, y
        torch.cuda.empty_cache()
    layer1_rows = []

    # layer 1 split across the card (K cut into ranges where the tiles
    # cannot fill it) at SPLIT_SHAPES: within SPLIT_LIMIT_DB of float32 x
    # @ W1, two launches bit-identical, timed; then BS32's bench shape in
    # one range (the launch that ran before the split walk)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for tag, (s1, nt1) in SPLIT_SHAPES.items():
        L1, H1 = nt1 * 320, SHAPE_MODEL[0]
        xs = torch.randn((2, s1, L1), generator=g, device=dev).to(bf16)
        ws = (torch.randn((2, L1, H1), generator=g, device=dev)
              / L1 ** 0.5).to(bf16)
        wst = ws.transpose(1, 2).contiguous()
        a, cnt = counted(lambda: factored_sig_proj(xs, ws, wst))
        require_launched(f"factored_sig_proj, {tag}", cnt,
                         ("factored_sig_proj", "factored_sig_proj split"))
        splits = sig_proj_splits(s1, H1, L1, sms)
        same(f"factored_sig_proj, {tag}: two launches ({splits} ranges)",
             factored_sig_proj(xs, ws, wst), a)
        ref = torch.bmm(xs.float(), ws.float())
        sp_err = check(f"factored_sig_proj, {tag}, {splits} ranges of K, vs "
                       f"f32 x @ W1", a, ref, SPLIT_LIMIT_DB)
        sp_ms = time_ms(lambda: factored_sig_proj(xs, ws, wst), iters=10)
        sp_plain = time_ms(lambda: xs.float() @ ws.float(), iters=2,
                           warmup=1)
        sp_lib = time_ms(lambda: torch.bmm(xs, ws), iters=10)
        sp_bound, sp_by = bound_ms(
            xs.numel() * 2 + wst.numel() * 2 + 2 * s1 * H1 * 4,
            2.0 * 2 * s1 * L1 * H1)
        print(f"  factored_sig_proj [{tag}: (2, {s1}, {L1}) @ (2, {L1}, "
              f"{H1}) bf16 -> f32, {splits} ranges of K]: {sp_ms:.5f} ms "
              f"(bound {sp_bound:.5f} ms by {sp_by}, "
              f"{sp_bound / sp_ms * 100:.1f}% of it); plain {sp_plain:.4f} "
              f"ms; library {sp_lib:.4f} ms")
        main_key, main_in = {
            "Nt 1024": ("fused_factored_planes Nt 1024",
                        "fused_factored_planes x1, Nt 1024 (phase 5o)"),
            "Nt 512": ("estimate_full Nt 512",
                       "estimate_full x1, Nt 512 (phase 5o)")}[tag]
        layer1_rows.append({
            "name": "factored_sig_proj",
            "shape": f"{tag}: (2, {s1}, {L1}) @ (2, {L1}, {H1}) bf16 -> "
                     f"f32, {splits} ranges of K",
            "route": "cuda",
            "source": "mamimo_tpu_torch/csrc/fused_factored.cu",
            "replaces": "mamimo_tpu/ops/pallas/fused_factored.py:169",
            "launches": counts[main_key]["factored_sig_proj split"],
            "launches_in": main_in, "splits": splits,
            "max_abs_err": sp_err["max_abs_err"],
            "nmse_db": sp_err["nmse_db"], "exact": False, "ms": sp_ms,
            "plain_ms": sp_plain, "bound_ms": sp_bound, "bound_by": sp_by,
            "library_ms": sp_lib, "call_ms": None, "ms_from": "events",
            "call_ms_from": "events"})
        errs[f"factored_sig_proj split {tag}"] = sp_err
        del xs, ws, wst, a, ref
        torch.cuda.empty_cache()
    # the float32 mode (3xTF32 on W1's TF32 parts) split at the same
    # shapes: within F32_LIMIT_DB of float32 x @ W1, two launches
    # bit-identical, timed beside its bound (W1 read once in float32, as
    # the bf16 row's) and the floor of the bytes it reads (both TF32 parts)
    for tag, (s1, nt1) in SPLIT_SHAPES.items():
        L1, H1 = nt1 * 320, SHAPE_MODEL[0]
        xs = torch.randn((2, s1, L1), generator=g, device=dev)
        ws = torch.randn((2, L1, H1), generator=g, device=dev) / L1 ** 0.5
        wsp = tf32_split(ws.transpose(1, 2).contiguous(), 1)
        a, cnt = counted(lambda: factored_sig_proj(xs, ws, wsp))
        require_launched(f"factored_sig_proj float32, {tag}", cnt,
                         ("factored_sig_proj f32",
                          "factored_sig_proj split f32"))
        splits = sig_proj_splits(s1, H1, L1, sms, float32=True)
        same(f"factored_sig_proj float32, {tag}: two launches ({splits} "
             f"ranges)", factored_sig_proj(xs, ws, wsp), a)
        with full_f32_matmul():
            ref = torch.bmm(xs, ws)
        sp_err = check(f"factored_sig_proj float32, {tag}, {splits} ranges "
                       f"of K, vs f32 x @ W1", a, ref, F32_LIMIT_DB)
        sp_ms = time_ms(lambda: factored_sig_proj(xs, ws, wsp), iters=10)
        with full_f32_matmul():
            # the plain version is the library call: torch.bmm f32, TF32
            # off
            sp_plain = time_ms(lambda: torch.bmm(xs, ws), iters=3,
                               warmup=1)
        out_b = 2 * s1 * H1 * 4
        sp_bound, sp_by = bound_ms(xs.numel() * 4 + ws.numel() * 4 + out_b,
                                   2.0 * 2 * s1 * L1 * H1, TF32_FLOPS)
        parts_ms = (xs.numel() * 4 + wsp.numel() * 4 + out_b) \
            / HBM_BYTES_PER_S * 1e3
        print(f"  factored_sig_proj float32 [{tag}: (2, {s1}, {L1}) @ (2, "
              f"{L1}, {H1}) f32 -> f32, {splits} ranges of K]: {sp_ms:.5f} "
              f"ms (bound {sp_bound:.5f} ms by {sp_by}, "
              f"{sp_bound / sp_ms * 100:.1f}% of it; both TF32 parts' bytes "
              f"{parts_ms:.5f} ms, {parts_ms / sp_ms * 100:.1f}%); plain "
              f"{sp_plain:.4f} ms = the library call (torch.bmm f32, TF32 "
              f"off)")
        layer1_rows.append({
            "name": "factored_sig_proj",
            "shape": f"{tag}, float32 mode: (2, {s1}, {L1}) @ (2, {L1}, "
                     f"{H1}) f32 -> f32, {splits} ranges of K",
            "route": "cuda",
            "source": "mamimo_tpu_torch/csrc/fused_factored.cu",
            "replaces": "mamimo_tpu/ops/pallas/fused_factored.py:169",
            "launches": counts[f"fused_factored_planes f32 {tag}"][
                "factored_sig_proj split f32"],
            "launches_in": f"fused_factored_planes(dot_dtype=float32) x1, "
                           f"{tag} (phase 5o)", "splits": splits,
            "max_abs_err": sp_err["max_abs_err"],
            "nmse_db": sp_err["nmse_db"], "exact": False, "ms": sp_ms,
            "plain_ms": sp_plain, "bound_ms": sp_bound, "bound_by": sp_by,
            "library_ms": sp_plain, "call_ms": None, "ms_from": "events",
            "call_ms_from": "events"})
        errs[f"factored_sig_proj split f32 {tag}"] = sp_err
        del xs, ws, wsp, a, ref
        torch.cuda.empty_cache()
    xs = torch.randn((2, BENCH_PACKETS * 4, 10240), generator=g,
                     device=dev)
    ws = 0.01 * torch.randn((2, 10240, SHAPE_MODEL[0]), generator=g,
                            device=dev)
    for dt in (bf16, f32):
        x_, w_ = xs.to(dt), ws.to(dt)
        wt_ = w_.transpose(1, 2).contiguous()
        if dt == f32:
            wt_ = tf32_split(wt_, 1)
        _, cnt = counted(lambda: factored_sig_proj(x_, w_, wt_))
        splits = sig_proj_splits(xs.shape[1], ws.shape[2], 10240, sms,
                                 float32=dt == f32)
        print(f"  factored_sig_proj {str(dt)[6:]} at BS32's bench shape (2, "
              f"{xs.shape[1]}, 10240) @ (2, 10240, {ws.shape[2]}): {splits} "
              f"range of K, split launches {cnt['factored_sig_proj split']}")
        if splits != 1 or cnt["factored_sig_proj split"]:
            raise AssertionError(f"BS32's layer 1 at S = 4096 was split "
                                 f"({str(dt)[6:]})")
        del x_, w_, wt_
    del xs, ws
    torch.cuda.empty_cache()

    # one Nt 1024 call at SHAPE_BIG_PACKETS packets: more than 2^31 input
    # elements, so every offset must be 64-bit; its last 8 samples
    # against the plain version run on those samples alone
    k16 = ls_sm90_constants(cfg, dev)
    s = SHAPE_BIG_PACKETS * cfg.num_rx
    xb = torch.randn((2, s, cfg.len_ltf), generator=g, device=dev,
                     dtype=bf16)
    hb, cnt = counted(lambda: ls_planes_v2(cfg, xb, k16))
    require_launched(f"ls_planes_v2, Nt 1024, S = {s}", cnt,
                     ("ls_planes_v2",))
    counts["ls_planes_v2 Nt 1024 big"] = cnt
    if not bool(torch.isfinite(hb).all()):
        raise AssertionError("ls_planes_v2 at Nt 1024, S = 4096: "
                             "non-finite output")
    errs["ls_planes_v2 Nt 1024 big"] = check(
        f"ls_planes_v2 bf16, Nt 1024, S = {s} ({xb.numel()} input "
        f"elements, all finite): its last 8 samples vs the plain version "
        f"on them alone", hb[:, -8:], _ls_v2_plain(
            cfg, xb[:, -8:].float()), -45.0)
    big_ms = time_ms(lambda: ls_planes_v2(cfg, xb, k16), iters=2,
                     warmup=0)
    print(f"  ls_planes_v2 bf16, Nt 1024, S = {s}: {big_ms:.4f} ms a call")
    del xb, hb
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t0
    print(f"[5o LS shapes] {secs:.1f} s")
    return {"errors": {k: ({n: r["nmse_db"] for n, r in v.items()}
                           if "nmse_db" not in v else v["nmse_db"])
                       for k, v in errs.items()},
            "served_nmse_db": {k: {n: v["nmse_db"] for n, v in d.items()}
                               for k, d in served.items()},
            "launches": counts, "big_ms": big_ms, "seconds": secs,
            "_errs": errs, "_rows": layer1_rows}


def ls_shapes_timing(dev, smi, res) -> list:
    """Phase 6's rows of the LS kernels at the new shapes (SHAPE_TIMED:
    Nt 512 at S = 512, Nt 1024 at S = 128, BS32 cp 18 at the bench shape
    S = 4096): kernels 1 (f32 store), 3 (raw; bf16 out for bf16 planes)
    and 4 in the bf16 mode and the float32 mode, each timed (CUDA events)
    beside its plain version, its bound (inputs read once, outputs written
    once; the DFT-select's products counted once at the bf16 or TF32
    peak) and one library call (the DFT-select as one matmul a plane,
    then the despread as one). At Nt 512 and 1024 a kernel's time holds
    its part transform's launch, as the wrapper makes it, and the
    transform has rows of its own (both modes). Launches: those of the
    main path where one runs the shape, else of phase 5o's checks. Phase
    5o's rows of kernel 2's layer 1 (split across the card at Nt 1024 and
    512, and the float32 mode at Nt 1024) come first."""
    import torch

    from mamimo_tpu_torch.bench import _planes_to_time_major
    from mamimo_tpu_torch.ops.estimate import (
        ls_estimate_matmul,
        ls_estimate_planes,
        ls_planes_constants,
    )
    from mamimo_tpu_torch.ops.kernels.fused_ls import (
        _ls_parts_plain,
        _ls_v1_plain,
        ls_estimate_pallas,
        ls_pair_kernel,
        ls_parts,
        ls_planes_pallas_v2_constants,
        ls_planes_v1,
        ls_planes_v2,
        ls_sm90_constants,
        pair_planes,
    )
    from mamimo_tpu_torch.ops.ltf import _hadamard_np
    from mamimo_tpu_torch.utils.numerics import full_f32_matmul

    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(101)
    errs, counts, rows = res["_errs"], res["launches"], list(res["_rows"])
    lsrc = "mamimo_tpu/ops/pallas/fused_ls.py:"
    for tag, S in SHAPE_TIMED.items():
        cfg = shape_cfg(tag)
        nt, nr, L, C = cfg.num_tx, cfg.num_rx, cfg.len_ltf, cfg.num_carriers
        fft = cfg.fft_length
        x32 = torch.randn((2, S, L), generator=g, device=dev)
        x16 = x32.to(bf16)
        f32c = ls_planes_constants(cfg, device=dev)
        n_main = counts[f"estimate_full {tag}"]["ls_planes_v2"]
        checks = f"phase 5o's checks, {tag}"
        if tag in PARTS_LIMITS_DB:
            # the part transform alone: the planes' fft samples read once,
            # the transform written once; its library call: H_nl times an
            # as_strided view of the planes (symbol m of part v at sample
            # s, its fft samples after the cyclic prefix), one matmul
            nl, sl, cp = nt // 128, cfg.sym_len, cfg.cp_length
            hnl = torch.from_numpy(_hadamard_np(nl).astype(np.float32)).to(
                dev)
            for x in (x16, x32):
                mode = "bf16" if x.dtype == bf16 else "float32"
                ms = time_ms(lambda x=x: ls_parts(cfg, x), iters=10)
                plain_ms = time_ms(lambda x=x: _ls_parts_plain(cfg, x, nt),
                                   iters=2, warmup=1)
                yv = torch.as_strided(x, (2, S, 128, nl, fft),
                                      (S * L, L, sl, 128 * sl, 1), cp)
                hx = hnl.to(x.dtype)
                with full_f32_matmul():
                    zl = torch.matmul(hx, yv)        # (2, S, 128, nl, fft)
                    lib_ms = time_ms(lambda hx=hx, yv=yv: torch.matmul(
                        hx, yv), iters=10)
                check(f"  ls_parts library call ({mode}, {tag}) vs the "
                      f"plain version", zl.permute(0, 1, 3, 2, 4).reshape(
                          2, S, nt * fft),
                      _ls_parts_plain(cfg, x, nt), -45.0)
                del zl
                bms, by = bound_ms(2 * 2 * S * nt * fft * x.element_size(),
                                   0.0)
                shape = (f"{tag}, {mode} planes (2, {S}, {L}) -> (2, {S}, "
                         f"{nt * fft})")
                print(f"  ls_parts [{shape}]: {ms:.5f} ms (bound {bms:.5f} "
                      f"ms by {by}, {bms / ms * 100:.1f}% of it); plain "
                      f"{plain_ms:.4f} ms; library {lib_ms:.4f} ms  "
                      f"[{smi}]")
                rows.append({
                    "name": "ls_parts", "shape": shape, "route": "cuda",
                    "source": "mamimo_tpu_torch/csrc/ls_parts.cu",
                    "replaces": lsrc + "424",
                    "note": "the first pass of kernels 1, 3 and 4 at 512 "
                            "symbols a sample and more (a part of their "
                            "TPU kernels' despread)",
                    "launches": counts[f"estimate_full {tag}"]["ls_parts"]
                    if mode == "bf16" else counts[tag]["ls_parts"],
                    "launches_in": f"estimate_full x1, {tag}"
                    if mode == "bf16" else checks,
                    "max_abs_err": 0.0, "nmse_db": None, "exact": True,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                    "bound_by": by, "library_ms": lib_ms, "call_ms": None,
                    "ms_from": "events", "call_ms_from": "events"})
        for dt, k, x, peak in ((bf16, ls_sm90_constants(cfg, dev), x16,
                                BF16_FLOPS),
                               (f32, ls_sm90_constants(cfg, dev, f32), x32,
                                TF32_FLOPS)):
            mode = "bf16" if dt == bf16 else "float32"
            esz = x.element_size()
            bv2, _ = ls_planes_pallas_v2_constants(cfg, 1, dt, dev)
            cp_ = bv2.shape[1] // 2

            def library(x=x, bv2=bv2, cp_=cp_):
                t = torch.matmul(x.view(2, S * nt, cfg.sym_len), bv2).float()
                zr = t[0, :, :C] - t[1, :, cp_:cp_ + C]
                zi = t[0, :, cp_:cp_ + C] + t[1, :, :C]
                return torch.matmul(f32c[2], torch.stack([zr, zi]).view(
                    2, S, nt, C))

            ls_in = 2 * S * nt * fft * esz + k.bt.numel() * esz
            ops = 2.0 * (S * nt) * (2 * fft) * (2 * C)
            rx = _planes_to_time_major(x.float(), nr)
            ppl = pair_planes(rx, dt)
            rows_out = -(-S // 8) * 8 * nt
            e = errs[tag]
            key = "" if dt == bf16 else " f32"
            for name, src, repl, kern, plain, nbytes, launches, path in (
                    ("ls_planes_v2", "ls_v2.cu", lsrc + "424",
                     lambda: ls_planes_v2(cfg, x, k),
                     lambda: ls_estimate_planes(cfg, x.float(), f32c),
                     ls_in + 2 * S * nt * C * 4,
                     n_main if dt == bf16 and n_main else
                     counts[tag]["ls_planes_v2" + key],
                     f"estimate_full x1, {tag}"
                     if dt == bf16 and n_main else checks),
                    ("ls_planes_v1", "ls_v1.cu", lsrc + "253",
                     lambda: ls_planes_v1(cfg, x, k, out_dtype=dt),
                     lambda: _ls_v1_plain(cfg, x, 8, dt),
                     ls_in + 2 * rows_out * 2 * cp_ * esz // 2,
                     counts[tag]["ls_planes_v1" + key], checks),
                    ("ls_pair_kernel", "ls_pair.cu", lsrc + "110",
                     lambda: ls_pair_kernel(cfg, ppl, nr, k),
                     lambda: ls_estimate_matmul(cfg, rx),
                     ls_in + S * nt * C * 8,
                     counts[tag]["ls_pair_kernel" + key], checks)):
                ms = time_ms(kern, iters=10)
                plain_ms = time_ms(plain, iters=2, warmup=1)
                lib_ms = time_ms(library, iters=5, warmup=1)
                bms, by = bound_ms(nbytes, ops, peak)
                shape = (f"{tag}, {mode} mode: planes (2, {S}, {L}) "
                         f"{str(dt)[6:]}")
                print(f"  {name} [{shape}]: {ms:.5f} ms (bound {bms:.5f} ms "
                      f"by {by}, {bms / ms * 100:.1f}% of it); plain "
                      f"{plain_ms:.4f} ms; library {lib_ms:.4f} ms  [{smi}]")
                err = e[name + key]
                rows.append({"name": name, "shape": shape, "route": "cuda",
                             "source": f"mamimo_tpu_torch/csrc/{src}",
                             "replaces": repl, "launches": launches,
                             "launches_in": path,
                             "max_abs_err": err["max_abs_err"],
                             "nmse_db": err["nmse_db"], "exact": False,
                             "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                             "bound_by": by, "library_ms": lib_ms,
                             "call_ms": None, "ms_from": "events",
                             "call_ms_from": "events"})
            del rx, ppl
        del x16, x32
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "mamimo_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} holds no mamimo_tpu_torch sources",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from mamimo_tpu_torch.bench import (
        ESTIMATION_PATHS,
        PATHS,
        _planes_to_time_major,
        make_estimation_fn,
        make_estimation_fn_pallas_factored,
        make_estimation_fn_planes,
        make_estimation_fn_serving_r3,
        run_bench,
    )
    from mamimo_tpu_torch.entry import entry
    from mamimo_tpu_torch.config import SimConfig, TrainConfig
    from mamimo_tpu_torch.models.mlp import (
        _factored_all_pairs,
        plane,
        predict_all_pairs_planes,
        predict_complex,
        preprocess_input,
    )
    from mamimo_tpu_torch.models.predictor import CSIPredictor, full_f32_matmul
    from mamimo_tpu_torch.ops.estimate import (
        ls_estimate_matmul,
        ls_estimate_planes,
        ls_matmul_constants,
        ls_planes_constants,
    )
    from mamimo_tpu_torch.ops.kernels import _build
    from mamimo_tpu_torch.ops.kernels.fused_factored import (
        _tail_plain,
        factored_dense,
        factored_heads,
        factored_rows_tail,
        factored_sig_proj,
        factored_tail,
        fused_factored_planes,
        prepare_factored_weights,
    )
    from mamimo_tpu_torch.channel.scattering import (
        ChannelRealization,
        apply_channel,
        make_scenario,
        realize_channel,
    )
    from mamimo_tpu_torch.models.mlp import predict_all_pairs
    from mamimo_tpu_torch.ops.kernels.fused_ls import (
        _ls_v1_plain,
        _ls_v2_plain,
        _ssq_plain,
        ls_estimate_pallas,
        ls_kernel_constants,
        ls_pair_kernel,
        ls_planes_pallas,
        ls_planes_pallas_v2_constants,
        ls_planes_v1,
        ls_planes_v2,
        ls_parts,
        ls_raw_to_complex,
        ls_sm90_constants,
        ls_v2_tiles,
        pair_planes,
    )
    from mamimo_tpu_torch.ops.kernels.int8_mm import (
        _matmul_int8_plain,
        matmul_float,
        matmul_int8,
    )
    from mamimo_tpu_torch.ops.kernels.mlp_infer import (
        _layer1_plain,
        _tail_plain as _mlp_tail_plain,
        mlp_infer_layer1,
        mlp_infer_pallas,
        mlp_infer_tail,
        predict_complex_pallas,
        prepare_mlp_infer_weights,
    )
    from mamimo_tpu_torch.ops.kernels.util import tf32_split
    from mamimo_tpu_torch.ops.ltf import (
        gen_preamble,
        pilot_p_matrix,
        preamble_scale,
    )
    from mamimo_tpu_torch.parallel.halo import (
        apply_channel_taps,
        channel_taps,
        sharded_apply_channel,
    )
    from mamimo_tpu_torch.parallel.mesh import make_mesh
    from mamimo_tpu_torch.parallel.rdma_halo import (
        _ext_complex_plain,
        _halo_exchange_complex,
        ext_block_plain,
        halo_exchange_pallas,
        sharded_apply_channel_rdma,
    )
    from mamimo_tpu_torch.parallel.sharded import (
        sharded_estimate_combined,
        sharded_ls_estimate,
        sharded_ls_pallas_v2,
        sharded_predict_all_pairs,
        sum_onto,
    )
    from mamimo_tpu_torch.pipeline.sounding import pad_signal
    from mamimo_tpu_torch.train.ckpt import save_checkpoint

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    bf16 = torch.bfloat16

    # 1. card ----------------------------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"[1 card] {name}; {torch.cuda.device_count()} visible, this run "
          f"uses 1 (cuda:0); torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    print(smi)

    # 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"[2 build] {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for src in _build.SOURCES:
        for line in _build.ptxas_report(src).splitlines():
            print(f"  {src}: {line.strip()}")
    # the Hopper kernels must run wgmma (HGMMA; IGMMA for int8) and no
    # mma.sync (HMMA; IMMA)
    for src, kerns, want, ban in (
            ("fused_factored", ("factored_sig_proj_kernel",
                                "factored_sig_proj_split_kernel",
                                "factored_tail_kernel",
                                "rows_gemm_kernel"), "HGMMA",
             "HMMA"),
            ("mlp_infer", ("mlp_layer1_kernel", "mlp_tail_kernel",
                           "rows_gemm_kernel"), "HGMMA", "HMMA"),
            ("ls_v2", tuple(V2_VARIANTS.values()), "HGMMA", "HMMA"),
            ("ls_v2", ("ls_planes_v2_f32_kernel",), "HGMMA", "HMMA"),
            ("ls_v1", ("ls_planes_v1_kernel", "ls_planes_v1_f32_kernel"),
             "HGMMA", "HMMA"),
            ("ls_pair", ("ls_pair_kernel", "ls_pair_f32_kernel"), "HGMMA",
             "HMMA"),
            # the general body (num_tx above 256, unaligned symbols)
            ("ls_v2", ("ls_planes_v2_any_kernel",
                       "ls_planes_v2_any_f32_kernel"), "HGMMA", "HMMA"),
            ("ls_v1", ("ls_planes_v1_any_kernel",
                       "ls_planes_v1_any_f32_kernel"), "HGMMA", "HMMA"),
            ("ls_pair", ("ls_pair_any_kernel", "ls_pair_any_f32_kernel"),
             "HGMMA", "HMMA"),
            ("matmul_bf16", ("mm_bf16_kernel",), "HGMMA", "HMMA"),
            ("matmul", ("mm_tf32x3_kernel",), "HGMMA", "HMMA"),
            ("fused_factored", ("factored_sig_proj_f32_kernel",
                                "factored_sig_proj_split_f32_kernel",
                                "factored_dense_f32_kernel",
                                "factored_rows_tail_f32_kernel"), "HGMMA",
             "HMMA"),
            ("mlp_infer", ("mlp_layer1_f32_kernel", "mlp_tail_f32_kernel"),
             "HGMMA", "HMMA"),
            ("int8_mm", ("int8_mm_kernel_slab", "int8_mm_kernel_ring"),
             "IGMMA", "IMMA")):
        for kname, ops in _build.sass_counts(src, kerns).items():
            print(f"  {src}: {kname} SASS: {ops[want]} {want}, "
                  f"{ops[ban]} {ban}")
            if ops[want] == 0 or ops[ban] != 0:
                raise AssertionError(f"{kname}: want {want} and no {ban} in "
                                     f"its SASS, got {ops}")

    # 3. kernels against their plain versions --------------------------
    def randint8(g, shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def check_kernels(cfg, tcfg, s, seed, tag, packets):
        """Each kernel against its plain version on the same inputs and a
        seeded model (the per-pair LS on `packets` whole packets); returns
        the model and the per-kernel results."""
        params, bn = make_model(cfg, tcfg, seed=seed, device=dev)
        prep = prepare_factored_weights(cfg, tcfg, params, bn)
        g = torch.Generator(device=dev).manual_seed(seed + 1)
        x16 = torch.randn((2, s, cfg.len_ltf), generator=g,
                          device=dev).to(bf16)
        x32 = x16.float()
        nt, C = cfg.num_tx, cfg.num_carriers
        print(f"[3 kernels] {tag}: Nt {nt}, hidden {tcfg.hidden}, S = {s}")
        res = {}
        k90 = ls_sm90_constants(cfg, dev)       # the LS kernels'
        ls2 = ls_planes_v2(cfg, x16, k90)
        h = ls_estimate_planes(cfg, x32, ls_planes_constants(cfg, device=dev))
        res["ls_planes_v2"] = check(
            "ls_planes_v2 vs ls_estimate_planes (f32)",
            ls2, torch.stack([h.real, h.imag]), -45.0)
        # seq mode: each rank's partial despread of its own symbols
        for n in (2, 4, 8):
            lq = cfg.len_ltf // n
            for i in range(n):
                r = check(f"ls_planes_v2 seq rank {i} of {n} vs its plain "
                          f"version (f32)", ls_planes_v2(
                              cfg, x16[:, :, i * lq:(i + 1) * lq].contiguous(),
                              k90, seq_shard=(i, n)),
                          _ls_v2_plain(cfg, x32[:, :, i * lq:(i + 1) * lq],
                                       (i, n)), -45.0)
                if (i, n) == (1, 4):        # the rank phase 6 times
                    res["ls_planes_v2 seq"] = r
        # the bf16 store and the sums of h^2, full mode and two seq ranks
        res["ls_planes_v2 bf16 ssq"] = check_v2_modes(
            cfg, x16, k90, f"S = {s}")[(bf16, True)]
        for i, n in ((1, 2), (3, 4)):
            lq = cfg.len_ltf // n
            check_v2_modes(cfg, x16[:, :, i * lq:(i + 1) * lq].contiguous(),
                           k90, f"S = {s}", (i, n))
        # v1: the raw padded planes in f32 and bf16, and the complex form
        ref_raw = torch.stack(_ls_v1_plain(cfg, x16, 8, torch.float32))
        for dt in (torch.float32, bf16):
            hr, hi = ls_planes_v1(cfg, x16, k90, out_dtype=dt)
            if hr.dtype != dt:
                raise AssertionError(f"ls_planes_v1 gave {hr.dtype}, want {dt}")
            check_pads_zero("ls_planes_v1", hr, hi, s, nt, C)
            r = check(f"ls_planes_v1 raw {str(dt)[6:]} vs its plain version "
                      f"(f32), pads zero", torch.stack([hr, hi]), ref_raw,
                      -45.0)
            res.setdefault("ls_planes_v1", r)
        check("ls_planes_pallas complex vs its plain version (f32)",
              ls_planes_pallas(cfg, x16, k90),
              ls_raw_to_complex(cfg, ref_raw[0], ref_raw[1], s), -45.0)
        # float32 planes: the kernels' float32 mode (float32 constants)
        k90f = ls_sm90_constants(cfg, dev, torch.float32)
        xf = torch.randn((2, s, cfg.len_ltf), generator=g, device=dev)
        hf = ls_estimate_planes(cfg, xf, ls_planes_constants(cfg, device=dev))
        hf = torch.stack([hf.real, hf.imag])
        res["ls_planes_v2 f32"] = check(
            "ls_planes_v2, float32 planes, vs ls_estimate_planes (f32)",
            ls_planes_v2(cfg, xf, k90f), hf, F32_LIMIT_DB)
        for mode, n in (("seq", 2), ("data", 2 if s % 2 == 0 else 1)):
            check(f"sharded_ls_pallas_v2 {mode} {n}, float32 planes, vs "
                  f"ls_estimate_planes (f32)", sharded_ls_pallas_v2(
                      cfg, make_mesh({mode: n}, devices=[dev] * n), xf,
                      mode=mode, consts=k90f), torch.complex(hf[0], hf[1]),
                  F32_LIMIT_DB)
        sp = factored_sig_proj(x16, prep["w1"], prep["w1t"])
        res["factored_sig_proj"] = check(
            "factored_sig_proj vs f32 x @ W1 (same bf16 operands)",
            sp, x32 @ prep["w1"].float(), -70.0)
        # the layer-1 GEMM's edges: 1 row, S*Nt - 3 rows, K % 64 != 0
        L1 = cfg.len_ltf - 24
        xr = torch.randn((2, s * nt - 3, cfg.len_ltf), generator=g,
                         device=dev).to(bf16)
        for tag, xe, w1e in (
                ("1 row", x16[:, :1], prep["w1"]),
                (f"{s * nt - 3} rows", xr, prep["w1"]),
                (f"K = {L1}", x16[:, :, :L1], prep["w1"][:, :L1])):
            check(f"factored_sig_proj {tag} vs f32 x @ W1", factored_sig_proj(
                xe, w1e, w1e.transpose(1, 2).contiguous()),
                xe.float() @ w1e.float(), -70.0)
        del xr
        y = factored_tail(prep, sp, C)
        res["factored_tail"] = check(
            "factored_tail vs its plain version (same sig_proj)",
            y, _tail_plain(prep, sp, C), -40.0)
        # the tail's edges: 1 sample, 65 samples (a second, almost empty
        # row block), 3 heads (the last cluster of heads half past nt)
        sp65 = torch.randn((2, 65, sp.shape[2]), generator=g,
                           device=dev) * sp.std()
        prep3 = {**prep, "hb": prep["hb"][:, :3].contiguous()}
        for tag, spe, pe in (("S = 1", sp[:, :1], prep),
                             ("S = 65", sp65, prep),
                             (f"3 heads, S = {s}", sp, prep3)):
            check(f"factored_tail {tag} vs its plain version",
                  factored_tail(pe, spe, C), _tail_plain(pe, spe, C), -40.0)
        check("fused DNN vs f32 _factored_all_pairs (bf16-valued weights)",
              fused_factored_planes(cfg, tcfg, prep, x16),
              _factored_all_pairs(cfg, tcfg, params, bn, x32), -40.0)
        # per-pair LS on the time-major form of whole packets' planes
        nr = cfg.num_rx
        rx = _planes_to_time_major(torch.randn(
            (2, packets * nr, cfg.len_ltf), generator=g,
            device=dev).to(bf16).float(), nr)
        with full_f32_matmul():
            ref_pp = ls_estimate_matmul(cfg, rx)
        res["ls_pair_kernel"] = check(
            f"ls_estimate_pallas ({packets} packets, float32 mode) vs "
            f"ls_estimate_matmul (f32)", ls_estimate_pallas(
                cfg, rx, consts=k90f), ref_pp, F32_LIMIT_DB)
        # the per-pair kernel's bf16 mode, on bf16 pair planes
        res["ls_pair_kernel bf16"] = check(
            f"ls_pair_kernel bf16 pair planes ({packets} packets) vs "
            f"ls_estimate_matmul (f32)", ls_pair_kernel(
                cfg, pair_planes(rx), nr, k90), ref_pp, -45.0)
        # fused MLP on materialized rows, M ragged, plane 1's weights
        with full_f32_matmul():
            p1 = plane(prepare_mlp_infer_weights(tcfg, params, bn), 1)
        m, k = s * nt - 3, cfg.len_ltf + nt
        xm = torch.randn((m, k), generator=g, device=dev).to(bf16)
        h1 = mlp_infer_layer1(p1, xm)
        res["mlp_infer_layer1"] = check(
            f"mlp_infer_layer1 ({m}, {k}), K % 64 = {k % 64}, vs its plain "
            f"version (same bf16 operands)", h1, _layer1_plain(p1, xm), -45.0)
        # 1 row; a K 24 shorter (its own zero-padded W1, K % 64 != 0)
        check(f"mlp_infer_layer1 (1, {k}) vs its plain version",
              mlp_infer_layer1(p1, xm[:1]), _layer1_plain(p1, xm[:1]), -45.0)
        k2 = k - 24
        w1k = torch.zeros_like(p1["w1"][:-(-k2 // 32) * 32])
        w1k[:k2] = p1["w1"][:k2]
        p1k = {**p1, "w1": w1k, "w1t": w1k.T.contiguous()}
        check(f"mlp_infer_layer1 ({m}, {k2}), K % 64 = {k2 % 64}, vs its "
              f"plain version", mlp_infer_layer1(p1k, xm[:, :k2]),
              _layer1_plain(p1k, xm[:, :k2]), -45.0)
        res["mlp_infer_tail"] = check(
            f"mlp_infer_tail ({m} rows) vs its plain version (same h1)",
            mlp_infer_tail(p1, h1), _mlp_tail_plain(p1, h1), -40.0)
        # 1 row: the cluster's second block lies wholly past M
        check("mlp_infer_tail (1 row) vs its plain version",
              mlp_infer_tail(p1, h1[:1]), _mlp_tail_plain(p1, h1[:1]), -40.0)
        with full_f32_matmul():
            ref_mlp = _mlp_tail_plain(p1, _layer1_plain(
                p1, xm, torch.float32), torch.float32)
        check("mlp_infer_pallas vs its plain version in f32 (bf16-valued "
              "weights)", mlp_infer_pallas(tcfg, p1, None, xm), ref_mlp,
              -40.0)
        # int8 GEMM at the three layer shapes of the int8 DNN, M ragged
        H1, H2 = tcfg.hidden
        for lyr, m, k, n in (("layer 1", s, cfg.len_ltf, H1),
                             ("layer 2", s * nt - 3, H1, H2),
                             ("layer 3", s * nt - 3, H2, C)):
            a, bt = randint8(g, (m, k)), randint8(g, (n, k))
            res.setdefault("matmul_int8", check_exact(
                f"matmul_int8 {lyr} ({m}, {k}) @ ({k}, {n}) vs float64 plain",
                matmul_int8(a, bt), _matmul_int8_plain(a, bt.T)))
        torch.cuda.synchronize()
        return params, bn, prep, res

    cfg, tcfg = SimConfig(), TrainConfig()
    params, bn, prep, res = check_kernels(cfg, tcfg, S_CHECK, 0,
                                          "BS32, full width",
                                          S_CHECK // cfg.num_rx)
    # the largest int32 sum layer 1 can make: 10240 products of 127·(−127)
    a = torch.full((64, cfg.len_ltf), 127, dtype=torch.int8, device=dev)
    bt = torch.full((tcfg.hidden[0], cfg.len_ltf), -127, dtype=torch.int8,
                    device=dev)
    check_exact("matmul_int8 all ±127, K = 10240 (int32 range)",
                matmul_int8(a, bt), _matmul_int8_plain(a, bt.T))
    # ragged edges: rows past the last full tile of each kernel
    check_kernels(cfg, tcfg, 7 * cfg.num_rx, 10, "BS32, 7 packets", 7)
    check_kernels(SimConfig(num_tx=8, num_rx=2), TrainConfig(hidden=(128, 128)),
                  11, 20, "small config, odd S", 7)

    def check_ls_edges(cfg, s, seed, tag, seqs, packets):
        """The two Hopper LS kernels at a tile edge: S = s samples (s * nt
        rows, the last 128-row tile partly past them), the seq mode at n
        ranks for each n of seqs (ranks 0, 1 and n - 1 against their
        plain version, the sum of all n partials against the full
        kernel), and `packets` whole packets through the per-pair
        kernel."""
        g = torch.Generator(device=dev).manual_seed(seed)
        k90 = ls_sm90_constants(cfg, dev)
        nt, nr, L = cfg.num_tx, cfg.num_rx, cfg.len_ltf
        x16 = torch.randn((2, s, L), generator=g, device=dev).to(bf16)
        x32 = x16.float()
        print(f"[3 LS edges] {tag}: Nt {nt}, S = {s} ({s * nt} rows, "
              f"{s * nt % 128 or 128} in the last tile)")
        full = ls_planes_v2(cfg, x16, k90)
        check(f"ls_planes_v2 {tag} vs its plain version (f32)", full,
              _ls_v2_plain(cfg, x32), -45.0)
        for n in seqs:
            lq = L // n
            parts = [ls_planes_v2(cfg, x16[:, :, i * lq:(i + 1) * lq]
                                  .contiguous(), k90, seq_shard=(i, n))
                     for i in range(n)]
            for i in sorted({0, 1, n - 1}):
                check(f"ls_planes_v2 {tag} seq rank {i} of {n} (loc "
                      f"{nt // n}) vs its plain version (f32)", parts[i],
                      _ls_v2_plain(cfg, x32[:, :, i * lq:(i + 1) * lq],
                                   (i, n)), -45.0)
            check(f"ls_planes_v2 {tag}: sum of the {n} seq partials vs the "
                  f"full kernel", sum(parts), full, -100.0)
        rx = _planes_to_time_major(torch.randn(
            (2, packets * nr, L), generator=g, device=dev).to(bf16).float(),
            nr)
        with full_f32_matmul():
            ref = ls_estimate_matmul(cfg, rx)
        rows = packets * nr * nt
        check(f"ls_estimate_pallas {tag}, {packets} packets ({rows} rows, "
              f"float32 mode) vs ls_estimate_matmul (f32)",
              ls_estimate_pallas(cfg, rx, consts=ls_sm90_constants(
                  cfg, dev, torch.float32)), ref, F32_LIMIT_DB)
        check(f"ls_pair_kernel bf16 {tag}, {packets} packets vs "
              f"ls_estimate_matmul (f32)", ls_pair_kernel(
                  cfg, pair_planes(rx), nr, k90), ref, -45.0)
        return x16, rx, k90

    x1, rx1, k90 = check_ls_edges(cfg, 1, 30, "BS32, S = 1", (2, 4, 32), 1)
    x5, _, _ = check_ls_edges(cfg, 5, 31, "BS32, S = 5", (2, 4, 32), 3)
    # the bf16 store and the sums at S = 1 and 5 (the last tile partly
    # past S), full mode and seq ranks of n = 2 and 4
    for xe in (x1, x5):
        for seq in (None, (1, 2), (3, 4)):
            lq = cfg.len_ltf // (1 if seq is None else seq[1])
            i = 0 if seq is None else seq[0]
            check_v2_modes(cfg, xe[:, :, i * lq:(i + 1) * lq].contiguous(),
                           k90, f"BS32, S = {xe.shape[1]}", seq)
    check_ls_edges(SimConfig(num_tx=8, num_rx=2), 1, 32, "Nt 8, S = 1",
                   (2, 8), 1)
    check_ls_edges(SimConfig(num_tx=128, num_rx=2), 3, 33, "Nt 128, S = 3",
                   (2, 4, 128), 2)

    # the v1 kernel where its tiles (128/Nt samples) end: S = 1, 3, 33;
    # block_samples 1 leaves the last tile partly past s_out at Nt 8, 32
    for nt_e in (8, 32, 128):
        cfg_e = SimConfig(num_tx=nt_e, num_rx=2)
        k90e = ls_sm90_constants(cfg_e, dev)
        ge = torch.Generator(device=dev).manual_seed(40 + nt_e)
        for s_e in (1, 3, 33):
            x_e = torch.randn((2, s_e, cfg_e.len_ltf), generator=ge,
                              device=dev).to(bf16)
            for block in (8, 1):
                ref_e = torch.stack(_ls_v1_plain(cfg_e, x_e, block,
                                                 torch.float32))
                for dt in (torch.float32, bf16):
                    hr, hi = ls_planes_v1(cfg_e, x_e, k90e,
                                          block_samples=block, out_dtype=dt)
                    tag = (f"ls_planes_v1 Nt {nt_e}, S = {s_e}, block "
                           f"{block}, {str(dt)[6:]}")
                    if hr.dtype != dt or hr.shape != ref_e[0].shape:
                        raise AssertionError(f"{tag}: {hr.dtype} "
                                             f"{tuple(hr.shape)}")
                    check_pads_zero(tag, hr, hi, s_e, nt_e,
                                    cfg_e.num_carriers)
                    check(f"{tag} vs its plain version (f32), pads zero",
                          torch.stack([hr, hi]), ref_e, -45.0)
    # the int8 GEMM at ragged M and N, through both of its bodies
    gi = torch.Generator(device=dev).manual_seed(50)
    for k_e in (16, 1024, 1040):
        for m_e in (1, 129, S_CHECK * cfg.num_tx - 3):
            for n_e in (8, 234, 1024):
                a, bt = randint8(gi, (m_e, k_e)), randint8(gi, (n_e, k_e))
                a[0], bt[-1] = 127, -127        # the extremes in place
                check_exact(f"matmul_int8 ({m_e}, {k_e}) @ ({k_e}, {n_e}) vs "
                            f"float64 plain", matmul_int8(a, bt),
                            _matmul_int8_plain(a, bt.T))
    # constants of the other layout are refused, not read
    kc1 = ls_kernel_constants(cfg, dev)
    for what, call in (
            ("ls_planes_v2", lambda: ls_planes_v2(cfg, x1, kc1)),
            ("ls_pair_kernel", lambda: ls_pair_kernel(
                cfg, pair_planes(rx1), cfg.num_rx, kc1)),
            ("ls_planes_v1", lambda: ls_planes_v1(cfg, x1, kc1))):
        try:
            call()
        except TypeError as e:
            print(f"  {what} refuses the other layout's constants: {e}")
        else:
            raise AssertionError(f"{what} took the other layout's constants")
    consts90 = ls_sm90_constants(cfg, dev)      # the LS kernels'
    f32_consts = ls_planes_constants(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)

    # 4. physics: noiseless preamble through flat channels -------------
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(str(Path(tmp) / "best"), cfg, tcfg, params, bn)
        pred = CSIPredictor(tmp, device="cuda")
        pred_cpu = CSIPredictor(tmp, device="cpu")
    nb, nt, nr = 64, cfg.num_tx, cfg.num_rx
    L, C = cfg.len_ltf, cfg.num_carriers
    gc = torch.Generator().manual_seed(2)
    H = torch.complex(torch.randn((nb, nt, nr), generator=gc),
                      torch.randn((nb, nt, nr), generator=gc)).numpy()
    pre = gen_preamble(cfg)                                 # (L, Nt)
    rx = pre[None] @ H                                      # (B, L, Nr)
    rxm = rx.transpose(0, 2, 1).reshape(nb * nr, L)
    planes = np.stack([rxm.real, rxm.imag]).astype(np.float32)
    h_ls, _ = pred.estimate_full(planes)                    # (S, Nt, C)
    want = np.broadcast_to(
        (H.transpose(0, 2, 1).reshape(nb * nr, nt)
         * preamble_scale(cfg, nt))[:, :, None], h_ls.shape)
    err = nmse_db(h_ls, want)
    worst = max(nmse_db(h_ls[..., c], want[..., c]) for c in range(C))
    print(f"[4 physics] {nb} packets, flat channels, no noise: served LS "
          f"NMSE {err:.2f} dB, worst carrier {worst:.2f} dB (limit -40 dB "
          f"on every carrier)")
    if not worst <= -40.0:
        raise AssertionError(f"physics: a carrier's LS NMSE is {worst:.2f} dB "
                             f"> -40 dB")

    all_kernels = (ls_planes_v2, factored_sig_proj, factored_tail,
                   factored_heads, factored_dense, factored_rows_tail,
                   ls_planes_v1, matmul_int8, ls_pair_kernel,
                   mlp_infer_layer1, mlp_infer_tail, halo_exchange_pallas,
                   matmul_float, tf32_split, ls_parts)
    # the wrappers with a float32 mode also count its launches apart
    f32_kernels = (ls_planes_v2, ls_planes_v1, ls_pair_kernel, matmul_float,
                   factored_sig_proj, factored_heads, factored_dense,
                   factored_rows_tail, mlp_infer_layer1, mlp_infer_tail)
    # the tails whose bf16 rows may run as two GEMMs count those apart
    gemm_tails = (factored_rows_tail, mlp_infer_tail)

    def counted(fn):
        """Run fn with every launch count set to 0 just before; returns
        fn's result and the counts just after ("<name> f32": the float32
        mode's share; "factored_sig_proj split": the launches of layer 1
        whose K was split across the card, "factored_sig_proj split f32"
        the float32 mode's of those; "<tail> gemms": the tails' launches
        on their two-GEMM route)."""
        for k in all_kernels:
            k.launches = 0
        for k in f32_kernels:
            k.launches_f32 = 0
        factored_sig_proj.launches_split = 0
        factored_sig_proj.launches_split_f32 = 0
        for k in gemm_tails:
            k.launches_gemms = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {**{k.__name__: k.launches for k in all_kernels},
                     **{f"{k.__name__} f32": k.launches_f32
                        for k in f32_kernels},
                     **{f"{k.__name__} gemms": k.launches_gemms
                        for k in gemm_tails},
                     "factored_sig_proj split":
                         factored_sig_proj.launches_split,
                     "factored_sig_proj split f32":
                         factored_sig_proj.launches_split_f32}

    def require_launched(what, counts, names):
        print(f"  launches in {what}: {counts}")
        idle = [n for n in names if counts[n] == 0]
        if idle:
            raise AssertionError(f"{what}: {idle} never launched: {counts}")

    # 5. serving: the main path, counted --------------------------------
    gr = torch.Generator().manual_seed(3)
    reqs = [torch.randn((2, 64 * nr, L), generator=gr).numpy()
            for _ in range(3)]
    outs, cnt_serve = counted(lambda: [pred.estimate_full(r) for r in reqs])
    shape = (64 * nr, nt, C)
    for h_ls, h_dnn in outs:
        for a in (h_ls, h_dnn):
            if a.shape != shape or a.dtype.name != "complex64":
                raise AssertionError(f"served {a.shape} {a.dtype}, "
                                     f"want {shape} complex64")
            if not np.isfinite(a).all():
                raise AssertionError("served non-finite values")
    # the first answer against the float32 plain versions on the f32 input
    x0 = torch.from_numpy(reqs[0]).to(dev)
    h0 = ls_estimate_planes(cfg, x0, f32_consts).cpu().numpy()
    d0 = _factored_all_pairs(cfg, tcfg, params, bn, x0).cpu()
    d0 = (d0[0] + 1j * d0[1]).numpy()
    served = {}
    for nm, got, ref in (("h_ls", outs[0][0], h0), ("h_dnn", outs[0][1], d0)):
        db = served[nm] = nmse_db(got, ref)
        if not db <= -40.0:
            raise AssertionError(f"served {nm}: NMSE {db:.2f} dB > -40 dB")
    print(f"[5 serving] 3 requests x 64 packets -> {shape} complex64 x2, "
          f"finite; vs f32 plain: h_ls {served['h_ls']:.2f} dB, "
          f"h_dnn {served['h_dnn']:.2f} dB")
    require_launched("estimate_full", cnt_serve,
                     ("ls_planes_v2", "factored_sig_proj", "factored_tail"))

    # 5b. int8 serving: all_pairs(int8=True), counted ------------------
    reqs4 = [torch.randn((2, 64, nr, L), generator=gr).numpy()
             for _ in range(3)]
    outs8, cnt_int8 = counted(
        lambda: [pred.all_pairs(r, int8=True) for r in reqs4])
    shape4 = (64, nr, nt, C)
    for a in outs8:
        if a.shape != shape4 or a.dtype.name != "complex64" \
                or not np.isfinite(a).all():
            raise AssertionError(f"all_pairs(int8=True) gave {a.shape} "
                                 f"{a.dtype}, want finite {shape4} complex64")
    ref_f32 = predict_all_pairs_planes(
        cfg, tcfg, params, bn, torch.from_numpy(reqs4[0]).to(dev)).cpu().numpy()
    ref_cpu = pred_cpu.all_pairs(reqs4[0], int8=True)
    int8_db = {"vs_f32_plain": nmse_db(outs8[0], ref_f32),
               "vs_int8_cpu": nmse_db(outs8[0], ref_cpu)}
    print(f"[5b int8] 3 requests x 64 packets -> {shape4} complex64, finite; "
          f"vs f32 all-pairs DNN {int8_db['vs_f32_plain']:.2f} dB (limit "
          f"-25), vs the int8 path on the CPU {int8_db['vs_int8_cpu']:.2f} dB "
          f"(limit -40)")
    require_launched("all_pairs(int8=True)", cnt_int8, ("matmul_int8",))
    if not (int8_db["vs_f32_plain"] <= -25.0
            and int8_db["vs_int8_cpu"] <= -40.0):
        raise AssertionError(f"all_pairs(int8=True) off its references: "
                             f"{int8_db}")

    # 5c. the four bf16-input planes paths, each counted ----------------
    def kernels_of(opts):
        ls_k = ("ls_planes_v1",) if opts.get("ls_pallas") else ()
        dnn_k = (("matmul_int8",) if opts.get("dnn_int8")
                 else ("factored_sig_proj", "factored_tail"))
        return ls_k + dnn_k

    fns = {pname: make_estimation_fn_planes(cfg, tcfg, params, bn,
                                            input_bf16=True, **opts)
           for pname, opts in PATHS.items()}
    xp16 = torch.randn((2, S_CHECK, L), generator=g, device=dev).to(bf16)
    xp32 = xp16.float()
    ls_ref = ls_estimate_planes(cfg, xp32, f32_consts)
    dnn_ref = _factored_all_pairs(cfg, tcfg, params, bn, xp32)
    dnn_ref = torch.complex(dnn_ref[0], dnn_ref[1])
    print(f"[5c planes] 4 bench paths, S = {S_CHECK} bf16 planes")
    cnt_paths, path_db = {}, {}
    for pname, fn in fns.items():
        (h_ls, h_dnn), cnt = counted(lambda: fn(xp16))
        if PATHS[pname].get("serving_planes"):
            h_ls = ls_raw_to_complex(cfg, h_ls[0], h_ls[1], S_CHECK)
            h_dnn = torch.complex(h_dnn[0].float(), h_dnn[1].float())
        lim = -25.0 if PATHS[pname].get("dnn_int8") else -40.0
        path_db[pname] = {
            "h_ls": check(f"{pname} h_ls vs f32 LS", h_ls, ls_ref, -45.0),
            "h_dnn": check(f"{pname} h_dnn vs f32 DNN", h_dnn, dnn_ref, lim)}
        require_launched(pname, cnt, kernels_of(PATHS[pname]))
        cnt_paths[pname] = cnt
    ls_v1_launches = sum(c["ls_planes_v1"] for c in cnt_paths.values())

    # 5d. the per-pair path pallas_full and predict_complex_pallas ------
    fn_full = make_estimation_fn(cfg, tcfg, params, bn,
                                 **ESTIMATION_PATHS["pallas_full"])
    fn_f32 = make_estimation_fn(cfg, tcfg, params, bn, from_planes=True)
    reqs_pf = [torch.randn((2, 64 * nr, L), generator=g, device=dev)
               for _ in range(3)]
    outs_pf, cnt_pf = counted(lambda: [fn_full(r) for r in reqs_pf])
    shape_pf = (64, C, nt, nr)
    for h_ls, h_dnn in outs_pf:
        for a in (h_ls, h_dnn):
            if tuple(a.shape) != shape_pf or a.dtype != torch.complex64 \
                    or not bool(torch.isfinite(torch.view_as_real(a)).all()):
                raise AssertionError(f"pallas_full gave {tuple(a.shape)} "
                                     f"{a.dtype}, want finite {shape_pf} "
                                     f"complex64")
    print(f"[5d per pair] pallas_full: 3 requests x 64 packets of f32 "
          f"planes -> {shape_pf} complex64 x2, finite")
    ref_ls, ref_dnn = fn_f32(reqs_pf[0])
    # a second DNN witness, unlike the factored f32 branch: the plain f32
    # chain on the materialized rows (b, r, t) = [sample b·Nr + r ‖ P.T[t]]
    # of the first MAT_PACKETS packets
    pil_t = pilot_p_matrix(nt, device=dev).T
    n_pair = MAT_PACKETS * nr
    with full_f32_matmul():
        prep_mlp = prepare_mlp_infer_weights(tcfg, params, bn)
        ys = []
        for d in range(2):
            p_d = plane(prep_mlp, d)
            xm_d = preprocess_input(
                cfg, tcfg, reqs_pf[0][d, :n_pair, None, :].expand(-1, nt, -1),
                pil_t.expand(n_pair, -1, -1)).reshape(n_pair * nt, -1)
            ys.append(_mlp_tail_plain(p_d, _layer1_plain(
                p_d, xm_d, torch.float32), torch.float32))
    mat = torch.complex(ys[0], ys[1]).view(MAT_PACKETS, nr, nt, C) \
        .permute(0, 3, 2, 1)
    full_db = {
        "h_ls": check("pallas_full h_ls (kernel 4's float32 mode) vs the "
                      "f32 branch (ls_estimate_matmul)", outs_pf[0][0],
                      ref_ls, F32_LIMIT_DB),
        "h_dnn": check("pallas_full h_dnn vs the f32 branch "
                       "(predict_all_pairs, factored)", outs_pf[0][1], ref_dnn,
                       -40.0),
        "h_dnn_vs_materialized": check(
            f"pallas_full h_dnn, first {MAT_PACKETS} packets, vs the plain f32 "
            f"chain on their {n_pair * nt} materialized rows",
            outs_pf[0][1][:MAT_PACKETS], mat, -40.0)}
    require_launched("pallas_full", cnt_pf, ("ls_pair_kernel",
                                             "ls_pair_kernel f32",
                                             "mlp_infer_layer1",
                                             "mlp_infer_tail"))
    sig =torch.complex(torch.randn((256, L), generator=g, device=dev),
                        torch.randn((256, L), generator=g, device=dev))
    pil = pilot_p_matrix(nt, device=dev).T[torch.arange(256, device=dev) % nt]
    got_pc, cnt_pc = counted(lambda: predict_complex_pallas(
        cfg, tcfg, prep_mlp, None, sig, pil))
    with full_f32_matmul():
        ref_pc = predict_complex(cfg, tcfg, params, bn, sig, pil)
    full_db["predict_complex_pallas"] = check(
        "predict_complex_pallas (256 rows) vs f32 predict_complex",
        got_pc, ref_pc, -40.0)
    require_launched("predict_complex_pallas", cnt_pc,
                     ("mlp_infer_layer1", "mlp_infer_tail"))

    # 5e. the sequence-parallel path on virtual ranks of one card -------
    d_seq = 4
    mesh = make_mesh({"seq": d_seq}, devices=[dev] * d_seq)
    gch = torch.Generator().manual_seed(5)
    chan = realize_channel(cfg, gch, make_scenario(cfg, gch))
    chan = ChannelRealization(*(t.to(dev) for t in chan))
    sig = pad_signal(cfg, gen_preamble(cfg)).to(dev)        # (11200, Nt)
    taps = channel_taps(cfg, chan, n_taps=cfg.fir_taps)
    chunk, halo = sig.shape[0] // d_seq, taps.shape[0] - 1
    print(f"[5e seq-parallel] {d_seq} virtual ranks on one card (cuda:0): "
          f"padded BS32 preamble {tuple(sig.shape)}, chunk {chunk}, "
          f"{taps.shape[0]} taps (halo {halo})")
    planes_r = [torch.view_as_real(sig[r * chunk:(r + 1) * chunk])
                .permute(2, 0, 1).contiguous() for r in range(d_seq)]
    chunks_r = [sig[r * chunk:(r + 1) * chunk] for r in range(d_seq)]

    def exchange_exact(tag, xs, halo_, complex_form=False):
        """Kernel 7 on every rank of a mesh of virtual ranks of this
        card, in the planes or the complex form: one launch, each block
        bit-exact against the plain exchange, rank 0's halo zero."""
        m = make_mesh({"seq": len(xs)}, devices=[dev] * len(xs))
        fn, plain = ((_halo_exchange_complex, _ext_complex_plain)
                     if complex_form else
                     (halo_exchange_pallas, ext_block_plain))
        got, cnt = counted(lambda: fn(m, xs, halo_))
        if cnt["halo_exchange_pallas"] != 1:
            raise AssertionError(f"halo_exchange_pallas {tag}: "
                                 f"{cnt['halo_exchange_pallas']} launches "
                                 f"for {len(xs)} ranks on one card, want 1")
        bad = [r for r, (b, x) in enumerate(zip(got, xs))
               if not torch.equal(b, plain(x, xs[r - 1] if r else None,
                                           halo_))]
        zero = got[0][..., :halo_, :] if not complex_form else got[0][:halo_]
        print(f"  halo_exchange_pallas {tag}, {len(xs)} ranks, 1 launch: "
              + (f"ranks {bad} differ from the plain exchange" if bad
                 else "exact"))
        if bad or bool((zero != 0).any()):
            raise AssertionError(f"halo_exchange_pallas {tag}: ranks {bad} "
                                 f"differ, or rank 0's halo is not zero")
        return check_exact(f"halo_exchange_pallas {tag}, rank 1", got[1],
                           plain(xs[1], xs[0], halo_))

    # the vector path (16-byte columns): the preamble's chunks as planes
    # (nt = 32) and as complex64 rows (64 floats), as the sharded
    # convolution passes them
    res["halo_exchange_pallas"] = exchange_exact(
        f"planes (2, {chunk}, 32), halo {halo}", planes_r, halo)
    exchange_exact(f"complex ({chunk}, 32), halo {halo}", chunks_r, halo,
                   complex_form=True)
    # the scalar path: rows that are not a multiple of 4 floats (nt = 3
    # planes, nt = 3 complex = 6 floats) and 16-byte rows at a 4-byte
    # offset; then rows of more than 256 16-byte columns, halo 0, 8 ranks
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    crnd = lambda *s: torch.complex(rnd(*s), rnd(*s))         # noqa: E731
    exchange_exact("scalar path, planes (2, 50, 3)",
                   [rnd(2, 50, 3) for _ in range(3)], 7)
    exchange_exact("scalar path, complex (50, 3)",
                   [crnd(50, 3) for _ in range(3)], 49, complex_form=True)
    exchange_exact("scalar path, planes (2, 37, 6)",
                   [rnd(2, 37, 6) for _ in range(4)], 36)
    exchange_exact("scalar path, planes (2, 40, 32) 4 bytes off 16", [
        rnd(2 * 40 * 32 + 1)[1:].view(2, 40, 32) for _ in range(4)], 9)
    exchange_exact("vector path, planes (2, 20, 1028)",
                   [rnd(2, 20, 1028) for _ in range(3)], 19)
    exchange_exact("vector path, halo 0", [rnd(2, 16, 8) for _ in range(2)],
                   0)
    exchange_exact("vector path, 8 ranks", [crnd(64, 4) for _ in range(8)],
                   33, complex_form=True)
    ext, cnt_halo = counted(lambda: halo_exchange_pallas(mesh, planes_r, halo))
    conv, cnt_conv = counted(
        lambda: sharded_apply_channel_rdma(cfg, mesh, sig, taps))
    for what, cnt in (("halo_exchange_pallas", cnt_halo),
                      ("sharded_apply_channel_rdma", cnt_conv)):
        print(f"  launches in {what}: {cnt}")
        if cnt["halo_exchange_pallas"] != 1:
            raise AssertionError(f"{what}: {cnt['halo_exchange_pallas']} halo "
                                 f"launches for {d_seq} ranks on one card, "
                                 f"want 1")
    ref_taps = apply_channel_taps(sig, taps)
    exact = apply_channel(cfg, sig, chan)
    seq_err = {
        "conv_vs_unsharded": float(torch.linalg.norm(conv - ref_taps)
                                   / torch.linalg.norm(ref_taps)),
        "conv_vs_phase_ramp": float(torch.linalg.norm(conv - exact)
                                    / torch.linalg.norm(exact))}
    print(f"  sharded_apply_channel_rdma {tuple(conv.shape)}: rel err "
          f"{seq_err['conv_vs_unsharded']:.3e} vs apply_channel_taps (limit "
          f"1e-4), {seq_err['conv_vs_phase_ramp']:.3e} vs apply_channel "
          f"(limit 5e-2, the band limit)")
    if not (seq_err["conv_vs_unsharded"] <= 1e-4
            and seq_err["conv_vs_phase_ramp"] <= 5e-2
            and bool(torch.isfinite(torch.view_as_real(conv)).all())):
        raise AssertionError(f"sharded_apply_channel_rdma: {seq_err}")
    # the sharded LS on bf16 planes, each mode counted
    xs16 = torch.randn((2, S_CHECK, L), generator=g, device=dev).to(bf16)
    un2 = ls_planes_v2(cfg, xs16, consts90)
    un_c = torch.complex(un2[0], un2[1])
    ls_f32 = ls_estimate_planes(cfg, xs16.float(), f32_consts)
    cnt_sls = {}
    for mode, n in (("seq", 2), ("seq", 4), ("data", 4)):
        m = make_mesh({mode: n}, devices=[dev] * n)
        h, cnt = counted(lambda: sharded_ls_pallas_v2(cfg, m, xs16, mode=mode))
        tag = f"sharded_ls_pallas_v2 {mode} {n}"
        seq_err[f"{mode}{n}_vs_unsharded_db"] = check(
            f"{tag} vs unsharded ls_planes_v2", h, un_c, -100.0)["nmse_db"]
        seq_err[f"{mode}{n}_vs_f32_db"] = check(
            f"{tag} vs f32 ls_estimate_planes", h, ls_f32, -45.0)["nmse_db"]
        print(f"  launches in {tag}: {cnt}")
        if cnt["ls_planes_v2"] != n:
            raise AssertionError(f"{tag}: {cnt['ls_planes_v2']} LS launches, "
                                 f"want {n}")
        cnt_sls[(mode, n)] = cnt["ls_planes_v2"]
    # the sharded inference forms against the unsharded f32 ones
    rx_i = torch.complex(torch.randn((8, L, nr), generator=g, device=dev),
                         torch.randn((8, L, nr), generator=g, device=dev))
    ref_ls_i = ls_estimate_matmul(cfg, rx_i)
    ref_dnn_i = predict_all_pairs(cfg, tcfg, params, bn, rx_i)
    mesh3 = make_mesh({"data": 2, "seq": 2, "antenna": 2}, devices=[dev] * 8)
    c_ls, c_dnn = sharded_estimate_combined(cfg, tcfg, mesh3, params, bn, rx_i)
    for tag, got, ref in (
            ("sharded_ls_estimate (seq 4)", sharded_ls_estimate(
                cfg, make_mesh({"seq": 4}, devices=[dev] * 4), rx_i), ref_ls_i),
            ("sharded_predict_all_pairs (antenna 4)", sharded_predict_all_pairs(
                cfg, tcfg, make_mesh({"antenna": 4}, devices=[dev] * 4),
                params, bn, rx_i), ref_dnn_i),
            ("sharded_estimate_combined h_ls (2 x 2 x 2)", c_ls, ref_ls_i),
            ("sharded_estimate_combined h_dnn (2 x 2 x 2)", c_dnn, ref_dnn_i)):
        seq_err[tag] = check(f"{tag} vs unsharded f32", got, ref,
                             -80.0)["nmse_db"]

    # 5f. the bench: pallas_ls_v2_serving_r3, entry(), run_bench --------
    fn_r3 = make_estimation_fn_serving_r3(cfg, tcfg, params, bn)
    reqs_r3 = [torch.randn((2, 64 * nr, L), generator=g, device=dev)
               .to(bf16) for _ in range(3)]
    outs_r3, cnt_r3 = counted(lambda: [fn_r3(r) for r in reqs_r3])
    shape_y2 = (2, 64 * nr, nt, C)
    shape_ssq = (ls_v2_tiles(64 * nr, nt), 2, C)
    for ssq, y2 in outs_r3:
        if tuple(y2.shape) != shape_y2 or y2.dtype != bf16 \
                or tuple(ssq.shape) != shape_ssq \
                or ssq.dtype != torch.float32 \
                or not bool(torch.isfinite(y2.float()).all()) \
                or not bool(torch.isfinite(ssq).all()):
            raise AssertionError(
                f"pallas_ls_v2_serving_r3 gave ssq {tuple(ssq.shape)} "
                f"{ssq.dtype}, y2 {tuple(y2.shape)} {y2.dtype}; want finite "
                f"{shape_ssq} float32 and {shape_y2} bfloat16")
    print(f"[5f bench] pallas_ls_v2_serving_r3: 3 requests x 64 packets of "
          f"bf16 planes -> sums {shape_ssq} f32, y2 {shape_y2} bf16, finite")
    x_r3 = reqs_r3[0].float()
    h_r3 = ls_estimate_planes(cfg, x_r3, f32_consts)
    bench_db = {
        "ssq": check("pallas_ls_v2_serving_r3 sums of h^2 vs the f32 plain "
                     "LS's", outs_r3[0][0], _ssq_plain(
                         torch.stack([h_r3.real, h_r3.imag]), nt), -40.0),
        "y2": check("pallas_ls_v2_serving_r3 y2 vs f32 _factored_all_pairs",
                    outs_r3[0][1], _factored_all_pairs(cfg, tcfg, params, bn,
                                                       x_r3), -40.0)}
    require_launched("pallas_ls_v2_serving_r3", cnt_r3,
                     ("ls_planes_v2", "factored_sig_proj", "factored_tail"))
    fn_e, (planes_e,) = entry()                 # BS32, 4 packets
    (e_ls, e_dnn), cnt_e = counted(lambda: fn_e(planes_e))
    ecfg = SimConfig()
    shape_e = (2, planes_e.shape[1], ecfg.num_tx, ecfg.num_carriers)
    for a in (e_ls, e_dnn):
        if tuple(a.shape) != shape_e or a.dtype != bf16 \
                or not bool(torch.isfinite(a.float()).all()):
            raise AssertionError(f"entry() gave {tuple(a.shape)} {a.dtype}, "
                                 f"want finite {shape_e} bfloat16")
    h_e = ls_estimate_planes(ecfg, planes_e)
    bench_db["entry_h_ls"] = check(
        "entry() h_ls (bf16) vs f32 ls_estimate_planes", e_ls,
        torch.stack([h_e.real, h_e.imag]), -45.0)
    require_launched("entry()", cnt_e,
                     ("ls_planes_v2", "factored_sig_proj", "factored_tail"))
    t_rb = time.perf_counter()
    short = run_bench(batch_packets=64, iters=2, print_result=False)
    eps = short["extra"]["estimates_per_s"]
    print(f"  run_bench(64 packets, 2 calls a window): "
          f"{time.perf_counter() - t_rb:.1f} s, {len(eps)} paths, value "
          f"{short['value']:.6g} estimates/s by {short['extra']['best_path']}"
          f", ls_fft {eps.get('ls_fft', 0):.6g} estimates/s, device "
          f"{short['extra']['device']}")
    if len(eps) != 16 or not all(v > 0 for v in eps.values()):
        raise AssertionError(f"run_bench gave {len(eps)} paths: {eps}")
    # the bench path pallas_factored alone, counted: every factored_tail
    # launch of it is kernel 2's bf16 store (out_dtype=bfloat16)
    fn_pf = make_estimation_fn_pallas_factored(cfg, tcfg, params, bn)
    _, cnt_pf = counted(lambda: fn_pf(reqs_r3[0].float()))
    require_launched("pallas_factored (kernel 2's bf16 store)", cnt_pf,
                     ("factored_sig_proj", "factored_tail"))
    print(f"  pallas_factored x1 (64 packets): factored_tail's bf16 store "
          f"launched {cnt_pf['factored_tail']} time(s)")
    del fn_pf

    # 5g. the training step at the full BS32 width -----------------------
    train = train_phase(cfg, dev, counted)

    # 5h. the sounding path: OFDM, LS forms, LMMSE, generate_dataset ------
    sound = sounding_phase(cfg, dev, counted, require_launched, pred)

    # 5i. the training pipeline: loader, fit, evaluation, serving, CLI ---
    pipe_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_pipeline_")
    pipe = pipeline_phase(cfg, dev, counted, require_launched, pipe_dir.name)

    # 5j. the closed loop: DNN CSI served, OMP, Viterbi, sweeps, CLI ------
    cl = closed_loop_phase(cfg, dev, counted, require_launched,
                           os.path.join(pipe_dir.name, "in_hbm"),
                           os.path.join(pipe_dir.name, "cli", "model"),
                           pipe_dir.name)

    # 5k. the sharded training step on virtual ranks, dryrun, hidden 64 --
    shard = sharded_phase(cfg, dev, counted, require_launched,
                          train["data"], pipe["keep"]["ds"])

    # 5l. every depth and width the port trains, and Nt 256 --------------
    wide = wide_phase(dev, smi, counted, require_launched)

    # 5m. the float32 modes of kernels 1, 3, 4 and kernel 6's modes -------
    f32m = f32_modes_phase(dev, smi, counted, require_launched)

    # 5n. the float32 modes of kernels 2 and 5, kernel 2's out_dtype -----
    dnn32 = dnn_f32_phase(dev, counted, require_launched)

    # 5o. kernels 1, 3 and 4 at every num_tx and cp_length ---------------
    shapes = ls_shapes_phase(dev, counted, require_launched)

    # 6. timing at the bench shape --------------------------------------
    S = BENCH_PACKETS * nr
    H1, H2 = tcfg.hidden
    xb16 = torch.randn((2, S, L), generator=g, device=dev).to(bf16)
    xb32 = xb16.float()
    print(f"[6 timing] S = {S} ({BENCH_PACKETS} packets), {smi}")
    # peak device memory of one pallas_full call on the bench shape
    torch.cuda.synchronize()
    live = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn_full(xb32)
    torch.cuda.synchronize()
    peak_full = torch.cuda.max_memory_allocated()
    del out
    print(f"  pallas_full peak device memory: {peak_full / 2**30:.3f} GiB "
          f"allocated, {(peak_full - live) / 2**30:.3f} GiB above the "
          f"{live / 2**30:.3f} GiB live before the call  [{smi}]")
    rows = []

    def row(kname, shape_, src, repl, kern, plain, lib, nbytes, ops,
            launches, path, peak=BF16_FLOPS, call=None, key=None,
            traced=None):
        """One kernel row. ms: CUDA events around back-to-back launches,
        or with ``traced`` the device time per call of the kernels whose
        name holds it in a profiler trace of kern (a call whose time the
        host sets); call_ms: CUDA events around the whole wrapper, or the
        host time per call with ``traced``."""
        rows.append(dict(name=kname, shape=shape_, source=src, replaces=repl,
                         kern=kern, plain=plain, lib=lib, nbytes=nbytes,
                         ops=ops, peak=peak, launches=launches, path=path,
                         call=call, key=key or kname, traced=traced))

    # LS: kernel, plain (f32), library (bf16 matmul DFT-select + despread)
    bv2, _ = ls_planes_pallas_v2_constants(cfg, 1, bf16, dev)
    cp_ = bv2.shape[1] // 2
    pm = f32_consts[2]

    def ls_library():
        t = torch.matmul(xb16.view(2, S * nt, cfg.sym_len), bv2).float()
        zr = t[0, :, :C] - t[1, :, cp_:cp_ + C]
        zi = t[0, :, cp_:cp_ + C] + t[1, :, :C]
        z = torch.stack([zr, zi]).view(2, S, nt, C)
        return torch.matmul(pm, z)

    # the LS kernels read only the fft samples of each symbol, never the CP
    ls_in = 2 * S * nt * cfg.fft_length * 2 + consts90.bt.numel() * 2
    ls_ops = 2.0 * (S * nt) * (2 * cfg.fft_length) * (2 * C)
    row("ls_planes_v2", f"planes (2, {S}, {L}) bf16 -> (2, {S}, {nt}, {C}) f32",
        "mamimo_tpu_torch/csrc/ls_v2.cu",
        "mamimo_tpu/ops/pallas/fused_ls.py:424",
        lambda: ls_planes_v2(cfg, xb16, consts90),
        lambda: ls_estimate_planes(cfg, xb32, f32_consts),
        ls_library, ls_in + 2 * S * nt * C * 4, ls_ops,
        cnt_serve["ls_planes_v2"], "estimate_full x3")
    tiles_b = ls_v2_tiles(S, nt)

    def ls_bf16_ssq_library():
        h = ls_library()
        return h.to(bf16), (h * h).view(2, tiles_b, -1, C).sum(2)

    row("ls_planes_v2", f"planes (2, {S}, {L}) bf16 -> (2, {S}, {nt}, {C}) "
        f"bf16 + sums of h^2 ({tiles_b}, 2, {C}) f32",
        "mamimo_tpu_torch/csrc/ls_v2.cu",
        "mamimo_tpu/ops/pallas/fused_ls.py:424",
        lambda: ls_planes_v2(cfg, xb16, consts90, out_dtype=bf16,
                             with_ssq=True),
        lambda: _ls_v2_plain(cfg, xb32, None, bf16, True),
        ls_bf16_ssq_library,
        ls_in + 2 * S * nt * C * 2 + tiles_b * 2 * C * 4, ls_ops,
        cnt_r3["ls_planes_v2"], "pallas_ls_v2_serving_r3 x3",
        key="ls_planes_v2 bf16 ssq")
    rows_out = -(-S // 8) * 8 * nt
    row("ls_planes_v1", f"planes (2, {S}, {L}) bf16 -> raw 2 x ({rows_out}, "
        f"{cp_}) bf16", "mamimo_tpu_torch/csrc/ls_v1.cu",
        "mamimo_tpu/ops/pallas/fused_ls.py:253",
        lambda: ls_planes_v1(cfg, xb16, consts90, out_dtype=bf16),
        lambda: _ls_v1_plain(cfg, xb16, 8, bf16),
        ls_library, ls_in + 2 * rows_out * cp_ * 2, ls_ops,
        ls_v1_launches, "planes paths x4")
    row("ls_planes_v1", f"planes (2, {S}, {L}) bf16 -> ({S}, {nt}, {C}) "
        f"complex64 (raw f32 + densify)", "mamimo_tpu_torch/csrc/ls_v1.cu",
        "mamimo_tpu/ops/pallas/fused_ls.py:253",
        lambda: ls_planes_pallas(cfg, xb16, consts90),
        lambda: ls_raw_to_complex(cfg, *_ls_v1_plain(cfg, xb16, 8,
                                                     torch.float32), S),
        ls_library, ls_in + S * nt * C * 8, ls_ops,
        ls_v1_launches, "planes paths x4")

    spb = factored_sig_proj(xb16, prep["w1"], prep["w1t"])
    w1f = prep["w1"].float()
    row("factored_sig_proj", f"(2, {S}, {L}) @ (2, {L}, {H1}) bf16 -> f32",
        "mamimo_tpu_torch/csrc/fused_factored.cu",
        "mamimo_tpu/ops/pallas/fused_factored.py:169",
        lambda: factored_sig_proj(xb16, prep["w1"], prep["w1t"]),
        lambda: torch.matmul(xb32, w1f),
        lambda: torch.matmul(xb16, prep["w1"]),
        2 * S * L * 2 + prep["w1"].numel() * 2 + 2 * S * H1 * 4,
        2.0 * 2 * S * L * H1, cnt_serve["factored_sig_proj"],
        "estimate_full x3")

    def tail_library():
        # one bmm over the planes per layer: (2, S*nt, H) @ (2, H, H)
        p = prep
        hh = (torch.relu(spb[:, :, None, :] + p["hb"][:, None])
              * p["a1"][:, None] + p["c1"][:, None]).to(bf16)
        h2 = torch.relu(torch.bmm(hh.view(2, S * nt, H1), p["w2"])
                        + p["b2"])
        h2 = (h2 * p["a2"] + p["c2"]).to(bf16)
        return torch.bmm(h2, p["w3"]).view(2, S, nt, -1)[..., :C]

    tail_bytes = (2 * S * H1 * 4 + sum(prep[k].numel() * prep[k].element_size()
                                       for k in ("hb", "a1", "c1", "w2", "b2",
                                                 "a2", "c2", "w3", "b3"))
                  + 2 * S * nt * C * 4)
    row("factored_tail", f"sig_proj (2, {S}, {H1}) f32 -> (2, {S}, {nt}, {C}) "
        f"f32", "mamimo_tpu_torch/csrc/fused_factored.cu",
        "mamimo_tpu/ops/pallas/fused_factored.py:169",
        lambda: factored_tail(prep, spb, C),
        lambda: _tail_plain(prep, spb, C),
        tail_library, tail_bytes, 2.0 * 2 * S * nt * (H1 * H2 + H2 * C),
        cnt_serve["factored_tail"], "estimate_full x3")

    # int8 GEMM at the int8 DNN's per-plane layer shapes
    gemm_ms = {}
    for lyr, m, k, n in (("layer 1", S, L, H1), ("layer 2", S * nt, H1, H2),
                         ("layer 3", S * nt, H2, C)):
        a, bt = randint8(g, (m, k)), randint8(g, (n, k))
        row("matmul_int8", f"{lyr}: ({m}, {k}) @ ({k}, {n}) int8 -> int32",
            "mamimo_tpu_torch/csrc/int8_mm.cu",
            "mamimo_tpu/ops/pallas/int8_mm.py:50",
            lambda a=a, bt=bt: matmul_int8(a, bt),
            lambda a=a, bt=bt: _matmul_int8_plain(a, bt.T),
            int_mm_library(a, bt), m * k + n * k + m * n * 4, 2.0 * m * n * k,
            cnt_int8["matmul_int8"], "all_pairs(int8=True) x3",
            peak=INT8_OPS)

    # per-pair LS: the kernel alone on the pair planes (the wrapper's
    # layout pass apart; the whole wrapper as call_ms), plain f32: first
    # its bf16 mode (library: bf16 matmuls; no path runs this mode since
    # ls_estimate_pallas computes in float32, as JAX's), then the float32
    # mode pallas_full runs (library: float32 matmuls, TF32 off)
    rx_b = _planes_to_time_major(xb32, nr)                  # (B, L, Nr)
    ppl = pair_planes(rx_b)
    lsc = ls_matmul_constants(cfg, device=dev)
    row("ls_pair_kernel", f"bf16 mode: pair planes (2, {S}, {L}) bf16 -> "
        f"({BENCH_PACKETS}, {C}, {nt}, {nr}) c64",
        "mamimo_tpu_torch/csrc/ls_pair.cu",
        "mamimo_tpu/ops/pallas/fused_ls.py:110",
        lambda: ls_pair_kernel(cfg, ppl, nr, consts90),
        lambda: ls_estimate_matmul(cfg, rx_b, lsc),
        ls_library, ls_in + S * nt * C * 8, ls_ops, 0,
        "none: ls_estimate_pallas runs the float32 mode",
        key="ls_pair_kernel bf16")
    consts90f = ls_sm90_constants(cfg, dev, torch.float32)
    # the float32 mode on genuine float32 planes (nonzero low TF32 parts,
    # many tiles a consumer warpgroup), held to ls_estimate_matmul here
    xg32 = torch.randn((2, S, L), generator=g, device=dev)
    rx_g = _planes_to_time_major(xg32, nr)
    with full_f32_matmul():
        ref_g = ls_estimate_matmul(cfg, rx_g, lsc)
    res["ls_pair_kernel f32 bench"] = check(
        f"ls_estimate_pallas float32 mode, bench shape ({BENCH_PACKETS} "
        f"packets), float32 planes, vs ls_estimate_matmul (f32)",
        ls_estimate_pallas(cfg, rx_g, consts=consts90f), ref_g, F32_LIMIT_DB)
    del ref_g
    ppl32 = pair_planes(rx_g, torch.float32)
    pair_layout_ms = time_ms(lambda: pair_planes(rx_g, torch.float32))
    print(f"  pair_planes (the float32 layout pass of ls_estimate_pallas): "
          f"{pair_layout_ms:.4f} ms  [{smi}]")
    bv2f, _ = ls_planes_pallas_v2_constants(cfg, 1, torch.float32, dev)

    def ls_library_f32():
        t = torch.matmul(xg32.view(2, S * nt, cfg.sym_len), bv2f)
        zr = t[0, :, :C] - t[1, :, cp_:cp_ + C]
        zi = t[0, :, cp_:cp_ + C] + t[1, :, :C]
        return torch.matmul(pm, torch.stack([zr, zi]).view(2, S, nt, C))

    row("ls_pair_kernel", f"float32 mode: rx ({BENCH_PACKETS}, {L}, {nr}) "
        f"c64 -> ({BENCH_PACKETS}, {C}, {nt}, {nr}) c64 (kernel on the "
        f"float32 pair planes; layout pass {pair_layout_ms:.4f} ms apart)",
        "mamimo_tpu_torch/csrc/ls_pair.cu",
        "mamimo_tpu/ops/pallas/fused_ls.py:110",
        lambda: ls_pair_kernel(cfg, ppl32, nr, consts90f),
        lambda: ls_estimate_matmul(cfg, rx_g, lsc),
        ls_library_f32, 2 * S * nt * cfg.fft_length * 4
        + consts90f.bt.numel() * 4 + S * nt * C * 8, ls_ops,
        cnt_pf["ls_pair_kernel f32"], "pallas_full x3", peak=TF32_FLOPS,
        call=lambda: ls_estimate_pallas(cfg, rx_g, consts=consts90f),
        key="ls_pair_kernel f32 bench")

    # fused MLP on the materialized rows of plane 0, per launch form
    M, K = S * nt, L + nt
    pm0 = plane(prep_mlp, 0)
    xm = torch.empty((S, nt, K), dtype=bf16, device=dev)
    xm[:, :, :L] = xb16[0][:, None, :]
    xm[:, :, L:] = pilot_p_matrix(nt, device=dev).T.to(bf16)
    xm = xm.view(M, K)
    h1b = mlp_infer_layer1(pm0, xm)
    w1k = pm0["w1"][:K]
    w3c = pm0["w3"][:, :C]

    def mlp_l1_library():
        h = torch.relu(torch.matmul(xm, w1k) + pm0["b1"])
        return (h * pm0["s1"] + pm0["t1"]).to(bf16)

    def mlp_tail_library():
        h = torch.relu(torch.matmul(h1b, pm0["w2"]) + pm0["b2"])
        return torch.matmul((h * pm0["s2"] + pm0["t2"]).to(bf16), w3c) \
            + pm0["b3"]

    nbytes_of = lambda *ts: sum(t.numel() * t.element_size()  # noqa: E731
                                for t in ts)
    row("mlp_infer_layer1", f"({M}, {K}) @ ({K}, {H1}) bf16 -> h1 bf16",
        "mamimo_tpu_torch/csrc/mlp_infer.cu",
        "mamimo_tpu/ops/pallas/mlp_infer.py:144",
        lambda: mlp_infer_layer1(pm0, xm), lambda: _layer1_plain(pm0, xm),
        mlp_l1_library,
        nbytes_of(xm, w1k, pm0["b1"], pm0["s1"], pm0["t1"], h1b),
        2.0 * M * K * H1, cnt_pf["mlp_infer_layer1"], "pallas_full x3")
    row("mlp_infer_tail", f"h1 ({M}, {H1}) bf16 -> ({M}, {C}) f32",
        "mamimo_tpu_torch/csrc/mlp_infer.cu",
        "mamimo_tpu/ops/pallas/mlp_infer.py:144",
        lambda: mlp_infer_tail(pm0, h1b), lambda: _mlp_tail_plain(pm0, h1b),
        mlp_tail_library,
        nbytes_of(h1b, pm0["w2"], pm0["b2"], pm0["s2"], pm0["t2"], w3c,
                  pm0["b3"]) + M * C * 4,
        2.0 * M * (H1 * H2 + H2 * C), cnt_pf["mlp_infer_tail"],
        "pallas_full x3")

    # kernel 7: one whole exchange over the 4 virtual ranks (one launch)
    # on the preamble's chunks, its device time from the profiler's trace
    # (the host time of the call apart, as call_ms); plain: every rank's
    # plain exchange; library: one torch.cat per rank of its left tail
    # (zeros on rank 0) and its chunk
    nt_ = planes_r[0].shape[2]
    tails = [torch.zeros((2, halo, nt_), device=dev)] + [
        x[:, chunk - halo:] for x in planes_r[:-1]]
    row("halo_exchange_pallas", f"{d_seq} ranks, one launch: {d_seq} x "
        f"(2, {chunk}, {nt_}) f32 -> {d_seq} x (2, {halo + chunk}, {nt_}) "
        f"f32, {d_seq - 1} tails of {halo} rows put",
        "mamimo_tpu_torch/csrc/halo.cu",
        "mamimo_tpu/parallel/rdma_halo.py:111",
        lambda: halo_exchange_pallas(mesh, planes_r, halo),
        lambda: [ext_block_plain(x, planes_r[r - 1] if r else None, halo)
                 for r, x in enumerate(planes_r)],
        lambda: [torch.cat([t, x], 1) for t, x in zip(tails, planes_r)],
        d_seq * (2 * chunk * nt_ * 4 + 2 * (halo + chunk) * nt_ * 4), 0.0,
        cnt_halo["halo_exchange_pallas"], f"halo_exchange_pallas, "
        f"{d_seq} ranks", call=lambda: halo_exchange_pallas(mesh, planes_r,
                                                            halo),
        traced="halo_card_kernel")
    # kernel 1's seq mode per rank: rank 1 of 4 (loc 8 symbols) at S = 4096
    loc = nt // 4
    lq = loc * cfg.sym_len
    xq16 = xb16[:, :, lq:2 * lq].contiguous()
    xq32 = xq16.float()
    pcols = pm[:, loc:2 * loc]

    def ls_seq_library():
        t = torch.matmul(xq16.view(2, S * loc, cfg.sym_len), bv2).float()
        zr = t[0, :, :C] - t[1, :, cp_:cp_ + C]
        zi = t[0, :, cp_:cp_ + C] + t[1, :, :C]
        return torch.matmul(pcols, torch.stack([zr, zi]).view(2, S, loc, C))

    row("ls_planes_v2", f"seq rank 1 of 4: planes (2, {S}, {lq}) bf16 -> "
        f"partial (2, {S}, {nt}, {C}) f32", "mamimo_tpu_torch/csrc/ls_v2.cu",
        "mamimo_tpu/ops/pallas/fused_ls.py:424",
        lambda: ls_planes_v2(cfg, xq16, consts90, seq_shard=(1, 4)),
        lambda: _ls_v2_plain(cfg, xq32, (1, 4)), ls_seq_library,
        2 * S * loc * cfg.fft_length * 2 + consts90.bt.numel() * 2
        + 2 * S * nt * C * 4,
        2.0 * (S * loc) * (2 * cfg.fft_length) * (2 * C),
        cnt_sls[("seq", 4)], "sharded_ls_pallas_v2(seq, 4)",
        key="ls_planes_v2 seq")

    kernels = []
    for r in rows:
        if r["traced"]:
            per = trace_kernels_ms(r["kern"], calls=20)
            ms = sum(v for n, v in per.items() if r["traced"] in n)
            if not ms > 0:
                raise AssertionError(f"{r['name']}: no {r['traced']} device "
                                     f"time in the profiler's trace: {per}")
            call_ms = host_ms(r["call"])
        else:
            ms = time_ms(r["kern"])
            call_ms = time_ms(r["call"]) if r["call"] else None
        plain_ms = time_ms(r["plain"], iters=3, warmup=1)
        lib_ms = time_ms(r["lib"])
        bms, by = bound_ms(r["nbytes"], r["ops"], r["peak"])
        if r["name"] == "matmul_int8":
            gemm_ms[r["shape"].split(":")[0]] = ms
        print(f"  {r['name']} [{r['shape']}]: {ms:.5f} ms (bound {bms:.5f} ms "
              f"by {by}, {bms / ms * 100:.1f}% of it); "
              f"plain {plain_ms:.4f} ms; library {lib_ms:.4f} ms"
              + (f"; whole wrapper {call_ms:.4f} ms"
                 + (" host" if r["traced"] else "") if call_ms else "")
              + f"  [{smi}]")
        kernels.append({
            "name": r["name"], "shape": r["shape"], "route": "cuda",
            "source": r["source"], "replaces": r["replaces"],
            "launches": r["launches"], "launches_in": r["path"],
            "max_abs_err": res[r["key"]]["max_abs_err"],
            "nmse_db": res[r["key"]]["nmse_db"],
            "exact": res[r["key"]].get("exact", False),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "call_ms": call_ms,
            "ms_from": "trace" if r["traced"] else "events",
            "call_ms_from": "host" if r["traced"] else "events",
        })

    # the serving calls on the device (planes in, estimates out)
    n_est = S * nt
    calls = {}
    xf = xb32.contiguous()
    calls["estimate_full"] = time_ms(lambda: pred.serve_planes(xf), iters=10)
    x4 = xf.view(2, BENCH_PACKETS, nr, L)
    calls["all_pairs(int8=True)"] = time_ms(
        lambda: pred.all_pairs_planes(x4, int8=True), iters=5)
    for pname, fn in fns.items():
        calls[pname] = time_ms(lambda fn=fn: fn(xb16), iters=5)
    calls["pallas_full"] = time_ms(lambda: fn_full(xb32), iters=5)
    calls["pallas_ls_v2_serving_r3"] = time_ms(lambda: fn_r3(xb16), iters=10)
    for cname, ms in calls.items():
        print(f"  {cname} device time: {ms:.4f} ms for {n_est} estimates = "
              f"{n_est / ms * 1e3:.6g} estimates/s  [{smi}]")
    gemms = 2 * sum(gemm_ms.values())
    int8_ms = calls["all_pairs(int8=True)"]
    print(f"  all_pairs(int8=True) split: 6 int8 GEMMs {gemms:.4f} ms "
          f"({gemms / int8_ms * 100:.1f}%), the rest (quantise, dequantise, "
          f"bias/relu/BN, complex) {int8_ms - gemms:.4f} ms  [{smi}]")
    k_ms = {k["name"]: k["ms"] for k in kernels}
    ls_pp = k_ms["ls_pair_kernel"]
    mlp_ms = 2 * (k_ms["mlp_infer_layer1"] + k_ms["mlp_infer_tail"])
    full_ms = calls["pallas_full"]
    print(f"  pallas_full split: per-pair LS kernel {ls_pp:.4f} ms, "
          f"2 x (mlp_infer_layer1 + mlp_infer_tail) {mlp_ms:.4f} ms "
          f"({mlp_ms / full_ms * 100:.1f}%), the rest (planes to complex, "
          f"pair planes, materialized x, complex out) "
          f"{full_ms - mlp_ms - ls_pp:.4f} ms  [{smi}]")
    # the same calls traced: each kernel's own time inside the call
    traced = {}
    for cname, fn, ours in (
            ("estimate_full", lambda: pred.serve_planes(xf),
             ("ls_planes_v2_kernel", "factored_sig_proj_kernel",
              "factored_tail_kernel")),
            ("pallas_ls_v2_serving_r3", lambda: fn_r3(xb16),
             ("ls_planes_v2_kernel", "factored_sig_proj_kernel",
              "factored_tail_kernel")),
            ("pallas_full", lambda: fn_full(xb32),
             ("ls_pair", "mlp_layer1_kernel", "mlp_tail_kernel"))):
        per = trace_kernels_ms(fn)
        if not per:
            print(f"  {cname} trace: no device time in the profiler's "
                  f"trace  [{smi}]")
            continue
        split = {k: sum(v for n, v in per.items() if k in n) for k in ours}
        others = sorted(((v, n) for n, v in per.items()
                         if not any(k in n for k in ours)), reverse=True)
        busy = sum(per.values())
        traced[cname] = {"kernels_ms": split, "other_kernels_ms":
                         sum(v for v, _ in others), "busy_ms": busy,
                         "call_ms": calls[cname]}
        print(f"  {cname} trace, device ms per call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; {len(others)} other kernels "
              f"{traced[cname]['other_kernels_ms']:.4f} (largest: "
              + ", ".join(f"{n[:60]} {v:.4f}" for v, n in others[:4])
              + f"); busy {busy:.4f} of the {calls[cname]:.4f} ms call, "
              f"idle {(1 - busy / calls[cname]) * 100:.1f}%  [{smi}]")
    # the sequence-parallel calls: the host time per call (what a caller
    # waits: these calls are host-bound) beside the device-busy time of
    # the same call in a profiler trace (every kernel's own time)
    k_halo = next(k for k in kernels if k["name"] == "halo_exchange_pallas")
    k_seq = next(k for k in kernels if k["shape"].startswith("seq rank"))
    m_seq4 = make_mesh({"seq": 4}, devices=[dev] * 4)
    m_data4 = make_mesh({"data": 4}, devices=[dev] * 4)
    # the sharded float32 forms on the genuine float32 planes, held to the
    # unsharded float32 plain LS before they are timed
    h_g = torch.view_as_real(ls_estimate_planes(cfg, xg32, f32_consts))
    for mode, m4 in (("seq", m_seq4), ("data", m_data4)):
        d = torch.view_as_real(sharded_ls_pallas_v2(
            cfg, m4, xg32, mode=mode, consts=consts90f)) - h_g
        rel = float(d.abs().max() / h_g.abs().max())      # as rel_err
        del d
        print(f"  sharded_ls_pallas_v2 {mode} 4, float32 planes, S = {S}: "
              f"{rel:.3e} of the unsharded float32 plain LS (limit "
              f"{F32_SHARD_REL})")
        if not rel <= F32_SHARD_REL:
            raise AssertionError(f"sharded_ls_pallas_v2 {mode} 4 at S = {S}: "
                                 f"{rel:.3e}")
    del h_g
    par_fns = {
        "halo_exchange_pallas (seq 4)":
            lambda: halo_exchange_pallas(mesh, planes_r, halo),
        "sharded_apply_channel_rdma (seq 4)":
            lambda: sharded_apply_channel_rdma(cfg, mesh, sig, taps),
        "sharded_apply_channel (plain exchange, seq 4)":
            lambda: sharded_apply_channel(cfg, mesh, sig, taps),
        "sharded_ls_pallas_v2 (seq 4)":
            lambda: sharded_ls_pallas_v2(cfg, m_seq4, xb16, mode="seq",
                                         consts=consts90),
        # float32 planes: kernel 1's float32 mode on each rank
        "sharded_ls_pallas_v2 float32 (seq 4)":
            lambda: sharded_ls_pallas_v2(cfg, m_seq4, xg32, mode="seq",
                                         consts=consts90f),
        "sharded_ls_pallas_v2 float32 (data 4)":
            lambda: sharded_ls_pallas_v2(cfg, m_data4, xg32, mode="data",
                                         consts=consts90f)}
    par_host, par_busy, par_halo, par_ls32 = {}, {}, {}, {}
    for cname, fn in par_fns.items():
        par_host[cname] = host_ms(fn)
        per = trace_kernels_ms(fn, calls=5)
        par_busy[cname] = sum(per.values()) if per else None
        par_halo[cname] = sum(v for n, v in per.items()
                              if "halo_card_kernel" in n)
        # the float32 LS kernels' own traced time in the call
        par_ls32[cname] = sum(v for n, v in per.items()
                              if "ls_planes_v2_f32_kernel" in n)
        share = par_busy[cname] / par_host[cname] * 100 if per else 0.0
        busy = (f"{par_busy[cname]:.4f} ms ({share:.1f}% of the host time)"
                if per else "not traced")
        ls32 = (f", of it the float32 LS kernels {par_ls32[cname]:.4f} ms"
                if par_ls32[cname] else "")
        print(f"  {cname}: host {par_host[cname]:.4f} ms per call; traced "
              f"device busy {busy}{ls32}  [{smi}]")
    shard_copies = lambda: [xb16[:, :, i * lq:(i + 1) * lq].contiguous()  # noqa: E731
                            for i in range(4)]
    copies_ms = time_ms(shard_copies, iters=5)
    parts = [ls_planes_v2(cfg, x, consts90, seq_shard=(i, 4))
             for i, x in enumerate(shard_copies())]
    allreduce_ms = time_ms(lambda: sum_onto(parts, dev), iters=5)
    hsum = sum_onto(parts, dev)
    complex_ms = time_ms(lambda: torch.complex(hsum[0], hsum[1]), iters=5)
    for cname in ("sharded_apply_channel_rdma (seq 4)",
                  "sharded_apply_channel (plain exchange, seq 4)"):
        if par_busy[cname] is not None:
            print(f"  {cname} split: halo kernel {par_halo[cname]:.4f} ms, "
                  f"other kernels {par_busy[cname] - par_halo[cname]:.4f} ms "
                  f"(traced); host time not covered by device work "
                  f"{par_host[cname] - par_busy[cname]:.4f} ms  [{smi}]")
    sls_ms = par_host["sharded_ls_pallas_v2 (seq 4)"]
    print(f"  sharded_ls_pallas_v2 (seq 4) split: 4 LS seq kernels about "
          f"{4 * k_seq['ms']:.4f} ms (rank 1's time x 4), shard copies "
          f"{copies_ms:.4f} ms, all-reduce (sum of 4 partials) "
          f"{allreduce_ms:.4f} ms, complex out {complex_ms:.4f} ms (CUDA "
          f"events, each alone), of the {sls_ms:.4f} ms host time  [{smi}]")
    par_split = {"halo_kernel_ms": k_halo["ms"],
                 "ls_seq_kernels_ms": 4 * k_seq["ms"],
                 "ls_seq_shard_copies_ms": copies_ms,
                 "ls_seq_allreduce_ms": allreduce_ms,
                 "ls_seq_complex_ms": complex_ms}
    shard["timing"] = sharded_timing(cfg, dev, smi, train["data"])
    train["rows"] = train_timing(cfg, train.pop("data"), smi)
    sound["timing"] = sounding_timing(cfg, dev, smi, xb32)
    pipe["timing"] = pipeline_timing(cfg, dev, smi, pipe.pop("keep"))
    cl["timing"] = closed_loop_timing(cfg, dev, smi, cl.pop("keep"),
                                      sound["timing"]["line"])
    pipe_dir.cleanup()
    dnn32_rows = dnn_f32_timing(dev, smi, dnn32)
    shapes_rows = ls_shapes_timing(dev, smi, shapes)
    shapes.pop("_errs")
    shapes.pop("_rows")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")

    # phase 5l's, 5m's, 5n's and 5o's rows last: the lookups by name above
    # read BS32's
    kernels += wide.pop("rows") + f32m.pop("rows") + dnn32_rows \
        + shapes_rows
    print(json.dumps({"kernels": kernels, "serving": {
        "S": S, "device_ms": calls,
        "estimates_per_s": {k: n_est / v * 1e3 for k, v in calls.items()},
        "int8_gemm_ms": gemms,
        "served_nmse_db": {k: finite(v) for k, v in served.items()},
        "int8_nmse_db": {k: finite(v) for k, v in int8_db.items()},
        "planes_paths_nmse_db": {k: {h: v[h]["nmse_db"] for h in v}
                                 for k, v in path_db.items()},
        "pallas_full_nmse_db": {k: v["nmse_db"] for k, v in full_db.items()},
        "bench_nmse_db": {k: v["nmse_db"] for k, v in bench_db.items()},
        "run_bench_64": {"value": short["value"],
                         "best_path": short["extra"]["best_path"],
                         "estimates_per_s": eps},
        "pallas_full_peak_bytes": peak_full,
        "pallas_full_peak_above_live_bytes": peak_full - live,
        "traced_ms": traced,
        "physics_ls_nmse_db": err,
        "physics_worst_carrier_nmse_db": worst},
        "seq_parallel": {
            "ranks": "virtual, all on cuda:0", "chunk": chunk, "halo": halo,
            "host_ms": par_host, "device_busy_ms": par_busy,
            "halo_kernel_traced_ms": par_halo, "split_ms": par_split,
            "ls_f32_kernel_traced_ms": par_ls32,
            "launches": {"halo_exchange_pallas": cnt_halo[
                "halo_exchange_pallas"], "sharded_apply_channel_rdma":
                cnt_conv["halo_exchange_pallas"],
                **{f"sharded_ls_pallas_v2 {m} {n}": c
                   for (m, n), c in cnt_sls.items()}},
            "errors": {k: finite(v) if v is not None else None
                       for k, v in seq_err.items()}},
        "train": train,
        "sounding": sound,
        "pipeline": pipe,
        "closed_loop": cl,
        "sharded_train": shard,
        "wide": wide,
        "f32_modes": f32m,
        "dnn_f32": dnn32,
        "ls_shapes": shapes,
        "card": smi}))
    # the run uses one card, cuda:0, whatever the number of visible cards
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
