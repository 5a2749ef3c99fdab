#!/usr/bin/env python3
"""Drive the PyTorch port (sdirt_tpu_torch) on one NVIDIA card and check it.

  python3 chip_smoke.py

Phases, each printing its elapsed seconds:
  0. device: a CUDA card is required (no CPU fallback); TF32 is switched off
     for matmuls and convolutions, so the depth net, the splat and the PSF
     MLP run in full f32;
  1. build: the CUDA kernels (K1 fused trace, K2 fused DP conv, K3 dense
     bf16 layer) are compiled with nvcc from sdirt_tpu_torch/csrc/, in parallel with K1's
     probe kernels and the native engine's g++ build; their -Xptxas -v reports, K1's SASS instruction count
     per ray (rf50mm, rf35mm) and K2's shared memory per launch printed;
  2. K2 vs plain: K2 against its plain PyTorch version on seeded inputs at
     the serve shape (1x512x768x3, ks 21), the training render's shape
     (4x512x768x3), a ragged shape and a batch of 2;
  3. serve path: ``python -m sdirt_tpu_torch.dfdp_net --stage sample`` on
     real_sample_set/ with the exported weights, through its main(); K2's
     launch count is read around it, and the scores are held against the
     JAX package's CPU numbers (sdirt_tpu_torch/reference/);
  4. K2 times (CUDA events, after warm-up): K2, its plain version, one
     render call and one depth-net frame at 512x768;
  5. K1 vs plain: the fused trace against its plain PyTorch version on the
     same rays, rf50mm and rf35mm, at the fit step's bundles (20000 x 64
     and 2048 x 64 rays) and a ragged one, and through dp_psf_fused with the
     same pupil samples;
  6. fit path: ``python -m sdirt_tpu_torch.fit_psfnet`` at the published
     width (rf50mm, mlp, ks 21, 512x768, bs 64 x 20000 rays, eval 1024 x
     65536 rays) for 21 steps, through its main(), with the lens analysis
     at -500 and -20000 mm; K1's launch count is read around it, the loss
     must fall, the analysis's RMS radii and PSF maps are held against
     sdirt_tpu_torch/reference/analysis_jax_cpu.json (5x the JAX spread)
     and its files read back, time_compare_psf's two times printed, and
     the fitted net is loaded into a serve-path PSFNetLens that renders
     one flat scene;
  7. shipped surrogate: the fit's lens and eval (K1 ground truth) on the
     exported F4_PSFNet_mlp, held against the JAX package's CPU numbers
     (sdirt_tpu_torch/reference/fit_psfnet_jax_cpu.json);
  8. K1 times (CUDA events, after warm-up): K1 and its plain version at both
     bundles and at an eval chunk's main bundle (65536 x 128), the wrapper's
     host time per call, trace+splat rays/s at bench.py's shape, a train
     step, an eval;
  9. training path: ``python -m sdirt_tpu_torch.dfdp_net --stage train``
     through its main(), on configs/dfdp_synthetic_train_512_v5.yml at its
     width (512x768, bs 4, style v5, lr 3e-5, warm start from the exported
     Sdirt_best_acc1), cut in length only (printed); K2's launch count is
     read around it and must be one per step and one per validation item
     at epochs 0 and 1; the losses must be finite; the exported best net is
     loaded into the --stage sample depth part; a rerun resumes and trains
     no step. Per step: the render and the train step (CUDA events), the
     host's data wait, pairs per second, peak device memory; a profiled
     loop of training steps gives the device's idle share; K2 and its plain
     version are timed on a training batch's PSF;
 10. train-step reference: three 128x192 bs 2 steps of the shipped net on
     the JAX package's stored renders and on the card's own render, held
     against sdirt_tpu_torch/reference/train_step_jax_cpu.json;
 11. render variants: ``python -m sdirt_tpu_torch.gate_render_variants``
     through its main(), for rf50mm and rf35mm at 512x768, ks 21: fused,
     fused_int8, scan and scan_f32 on the config's mlp, scan, basis and
     basis_int8 on the promoted student mlpb@256x48; every row's flat PSNR
     (both views) within 0.1 dB of the JAX package's CPU scan of the same
     lens and net, or, where the JAX CPU run of the same variant is itself
     outside that gate, of that run (and of it in any case where it exists),
     the perceptual distance within 5%
     (sdirt_tpu_torch/reference/render_variants_jax_cpu.json); K2 launched
     by the fused rows only; K2 vs plain on the fused_int8 PSF, the int8
     path on the card vs on the CPU; per variant and lens the render
     call's time and peak memory (at rf50mm with a torch.profiler
     breakdown), and the times of its parts; K3 per layer of both nets at
     the training render's 4 x 2 x 512 x 768 rows, on the chain's own
     activations, against its bound, its plain version and the library's
     bias + ReLU epilogue (torch._addmm_activation, timed only), and held
     to the plain version;
 12. rf35mm serve path: ``--stage sample`` on configs/dfdp_by_sdirt_rf35mm.yml
     through dfdp_net.main(), held against
     sdirt_tpu_torch/reference/stage_sample_rf35mm_jax_cpu.json (flat PSNR
     0.1 dB, depth 0.005, perceptual distance 5%);
 13. K2 at ks 35: against its plain version at 1x256x384, 4x256x384 and a
     ragged shape; its time, bound and plain time at the first two, and its
     shared memory per block (3 blocks must fit an SM);
 14. F/1.8 serve path: ``--stage sample`` on a copy of
     configs/dfdp_f18_farfield_256.yml that names the shipped depth net
     Sdirt_f18_farfield (F18_PSFNet_mlp_ks35, ks 35), held against
     sdirt_tpu_torch/reference/stage_sample_f18_jax_cpu.json (flat PSNR
     0.1 dB, depth 0.005, perceptual distance 5%); one render call's time,
     peak memory and torch.profiler breakdown;
 15. far-field A/B: ``python -m sdirt_tpu_torch.eval_farfield_ab`` through
     its main(), arms f4 (ks 21) and f18 (F/1.8, ks 35) on 16 v2 scenes at
     256x384, held against eval_farfield_ab_jax_cpu.json (acc1 columns
     0.005, MAE columns 0.5%), 16 K2 launches per arm;
 16. deblur: ``--stage sample --train-mode deblur`` on a copy of
     configs/dfdp_synthetic_train_128_deblur_cpu.yml that names the shipped
     Sdirt_deblur_demo_cpu (depth and refined-depth metrics within 0.005 of
     stage_sample_deblur_jax_cpu.json); ``--stage train --train-mode
     deblur`` on configs/dfdp_synthetic_train_256_deblur.yml at its width
     (256x384, bs 2, style v3), cut to 4 steps and 2 validation items (all
     three losses finite, K2 once per step and validation item); three
     128x192 deblur steps on the stored renders within 1e-3 of the JAX
     float64 losses (train_step_deblur_jax_cpu.json); a torch.profiler
     breakdown of one render + train step at 256x384, bs 2;
 17. stack and thin lens: ``--stage train`` on configs/dfdp_f4_2focus_256.yml
     at 256x384, bs 4, with its second view's surrogate the shipped
     F4_PSFNet_mlp@256 refocused to 5 m, cut as above (a 12-channel net, K2
     twice per step and validation item, the real captures skipped with the
     JAX log line); a torch.profiler breakdown of one render + train
     step; one ThinLens batch on the card against the CPU;
 18. mlpconv and siren fits: ``fit_psfnet.main()`` with ``--model mlpconv``
     and ``--model siren`` at the published width (11 steps and one eval
     each, ``--skip-analysis``: the analysis does not depend on the net and
     runs in phase 6): finite losses, K1 launches, each head's train step
     timed;
 19. baselines: pred_coc, pred_dpdnet, pred_modeling and pred_learn2reduce
     on a 512x768 depth map at ks 21, on the card against their CPU run
     (1e-6), ms per call;
 20. coherent demo: ``coherent_demo.main()`` at its defaults with
     ``--image``; then the coherent grid at the JAX run's sensor distance
     held against sdirt_tpu_torch/reference/coherent_jax_cpu.json (ring
     contrasts and radial profiles, COHERENT_TOL), ms per coherent grid;
 21. lens design: ``demo_lens_design.main()`` at its defaults on the JAX
     package's draws, its three RMS tables and RECOVERY OK held against
     sdirt_tpu_torch/reference/lens_design_jax_cpu.npz, ms per step;
 22. published training: ``--stage train --save-images`` through
     dfdp_net.main() on configs/dfdp_by_sdirt_rf50mm.yml at its width
     (512x768, bs 4, ks 21, lr 1e-4, F4_PSFNet_mlp, warm start
     Sdirt_best_acc1), its roots pointed at the committed NYU tree
     (sdirt_tpu_torch/reference/datasets/nyu2_train) and FlyingThings3D
     trees written here at 960x540 (4 train, 2 validation scenes), cut in
     length only (3 epochs, each training set cut to 2 steps by step_view,
     the per-epoch real box evaluation to one scene):
     finite losses, K2 once per step and validation item, the
     FlyingThings3D mix in epochs 0-1 and NYU alone in epoch 2, the saved
     images present with the JET maps at 512x768; per step the data wait,
     render and step ms and max_memory_allocated; the host ms of one JPEG
     decode and one EXR read;
 23. depth-side tools through their main(): eval_depth_ckpt (512x768,
     --val-len 2, every style and the real sets; acc1 and MAE within 0.005,
     one K2 launch per synthetic render), dp_disparity_probe (surrogate:
     within 0.01 px; --traced at 200 000 rays: K1 held against its plain
     version at that shape first (PSF L1, as phase 5), then K1 twice per
     depth, each disparity and sigma within 5x the JAX run's largest
     difference between two key pairs) and finetune_real_loo --steps 2
     --sets box (finite losses; zero-shot acc1, held-out acc1 and MAE
     within 0.005), against sdirt_tpu_torch/reference/depth_tools_jax_cpu.json;
     each tool's seconds;
 24. distillation: distill_basis_student's step on the JAX run's explicit
     queries (rf50mm, teacher mlp, student mlpb@256x48 warm from mlp@256,
     bs 8192), three losses within 1e-3 of the JAX float64 ones, its time
     and idle share; distill_basis_student.main() cut in length only to 200
     steps with two evals (16 K1 launches each), the loss falling, a
     --resume rerun from step 100 on the same stream, the saved student
     rendering through 'basis'; probe_teacher_l1.main() on the promoted
     rf50mm student within 5x the JAX spread over three keys
     (sdirt_tpu_torch/reference/distill_jax_cpu.json);
 25. student gate: gate_rf35_student.main() at the JAX script's defaults
     (rf35mm mlp@256: fused, fused_int8) and on the promoted rf35mm
     mlpb@256x48 (basis, scan, scan_f32), with the rf50mm calibration: every
     number within 0.1 dB of the JAX CPU run and the same verdicts, K2 once
     per view and scene on the fused rows only
     (student_gate_jax_cpu.json);
 26. multi-GPU: fit_psfnet.main(--mesh 1 1) at the published width on NCCL
     (5 steps, K1 on the rank); dfdp_net.main(--stage train --data-parallel)
     on the one card (the single-chip line, one step); then 2 gloo ranks on
     the one card: a (1, 2) fit step at bs 64 x 20 000 rays (10 000 traced
     per rank through K1) and a (2, 1) DfDP step at 512x768, bs 4, with the
     shipped net (each rank's half rendered through K2), held to the
     one-rank step on the same samples (1e-6; 1e-4 for the DfDP losses and
     BatchNorm statistics); each step's ms;
 27. native engine (both C++ libraries built in phase 1 beside nvcc, with
     g++ against zlib alone): the PNG/JPEG loader at each file's own size
     under NEAREST bit-equal to read_png (the flat l/r PNGs, the orbbec
     16-bit d.png) and read_jpeg (the 8 NYU JPEGs); its NEAREST and CUBIC
     resizes and the CanonFlatSet items under the native engine held
     against the JAX engine's CPU run (native_decode_jax_cpu.npz); load_batch
     equal to serial decodes; a garbage file raises IOError; host ms per
     512x768 PNG and 640x480 JPEG decode, native and numpy, and per
     load_batch of 16 PNGs on all cores and on one; the EXR decoder
     bit-equal to io/exr.py on FlyingThings3D trees as phase 22 writes
     them, the dataset items equal under both engines, host ms per read;
 28. single-image render: render_single_image at its published defaults
     (psf_grid 21, psf_ks 44 traced at 45, GEO_SPP rays per point and
     wavelength, the per-surface trace) on rf50mm as fit_psfnet loads it,
     refocused to 1 m, a 512x768 flat capture at -3000 mm, on the JAX run's
     own refocus and pupil draws: the output within 2e-3 (max) and 1e-4
     (mean) of the JAX package's op-by-op CPU run at 2048 seeded pixels and
     in each channel's sum (single_image_jax_cpu.npz); the PSF sums' gap;
     K1 and K2 not launched; the map's trace ms and its rays/s, the conv's
     ms (CUDA events), the render's device idle share from a profile_trace
     scope (its Chrome trace file read back) and a print_memory line;
 29. the kernels line, then the card's name and power limit, then the
     result line. Every phase that runs a render path (serve, training,
     gates, deblur, stack, eval, A/B, data-parallel, single image) sets
     K3's launch counter to 0 first and keeps its count beside the one its
     renders call for (K3_PER_RENDER); the kernels line lists them by path,
     and any mismatch fails this phase.
Any failure raises: the exit code is then not 0 and no result line is
printed.
"""

import collections
import copy
import glob
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BUDGET_S = 600.0
KS = 21
# Both versions sum the same exact f32 products of bf16 inputs in the same
# order; they differ in how the tap sums are reduced and in the divide
# (reciprocal times sum in the kernel), a few f32 ulps of the output. The
# serve path's linear luminance reaches degamma(1) = 1153, where one ulp is
# 1.2e-4, so 1e-3 is about 8 ulps there and ~10^4 ulps on [0, 1] inputs.
KERNEL_TOL = 1e-3
PSNR_TOL_DB = 0.1      # the JAX package's render-variant gate
DEPTH_TOL = 0.005
# the weight-free perceptual distance (MS-SSIM + GMSD) of a flat render
# against the JAX package's on the CPU, relative
PERC_RTOL = 0.05
BASIS_NET = "mlpb@256x48"       # both lenses' promoted surrogate
GATE_ROWS = {"mlp": ["--variants", "fused", "fused_int8", "scan", "--f32-baseline"],
             BASIS_NET: ["--variants", "scan", "basis", "basis_int8"]}
# K3 (render/dense_bf16.py) launches a render call: the 10 trunk layers and
# the head of a fused render, the 11 coefficient layers of a basis render,
# the head alone of a fused_int8 render (its trunk is int8); none for scan
K3_PER_RENDER = {"fused": 11, "basis": 11, "fused_int8": 1}
# {path: (K3 launches on it, the count its renders call for)}, filled by
# k3_record as the phases run; the result phase fails on any mismatch
K3_PATHS = {}
BF16_FLOPS = 989e12             # H100 SXM, dense bf16 tensor cores
INT8_OPS = 1979e12              # H100 SXM, dense int8 tensor cores
# K1 vs its plain version, rays live in both: the JAX package's own
# fused-vs-specialized gate (tests/test_fused_trace.py); at most 1 in 10^5
# rays may differ in validity; PSF L1 per point, ckpt/FUSED_TRACE.json's gate
K1_PXY_TOL = 5e-4               # mm
K1_XTAN_TOL = 1e-4
K1_RA_MISMATCH = 1e-5           # of all rays
PSF_L1_MEAN_TOL = 1e-4
PSF_L1_MAX_TOL = 1e-3
FIT_ARGS = ["--device", "cuda", "--lens", "lenses/rf50mm/lens_web.json",
            "--model", "mlp", "--ks", "21", "--res", "512", "768",
            "--focus-mm", "-1000", "--bs", "64", "--spp", "20000",
            "--iters", "20", "--evaluate-every", "10", "--eval-bs", "1024",
            "--eval-spp", "65536"]
# the other heads at the same width, cut in length: 11 steps and one eval;
# the lens analysis, which does not depend on the net, runs in phase 6
HEAD_FIT_ARGS = ["--device", "cuda", "--lens", "lenses/rf50mm/lens_web.json",
                 "--ks", "21", "--res", "512", "768", "--focus-mm", "-1000",
                 "--bs", "64", "--spp", "20000", "--iters", "10",
                 "--evaluate-every", "11", "--eval-bs", "1024", "--eval-spp", "65536",
                 "--skip-analysis"]
BASELINES = ("pred_coc", "pred_dpdnet", "pred_modeling", "pred_learn2reduce")
# plain tensor functions: the card against its own CPU run
BASELINE_TOL = 1e-6
COHERENT_DEPTHS = (-1000.0, -1100.0, -1300.0)
# the coherent demo against the JAX CPU run made op by op (each operation
# rounded as written, as the port computes), at that run's sensor distance.
# The coherent PSF is f32-limited (a ray's first step, t ~ 1 m, carries ~0.6
# rad of phase rounding); the port on the CPU is within 0.005 (ring contrast)
# and 0.038 (radial profile) of it for the coherent PSF, 2.6e-5 (profile)
# for the incoherent one, at these settings; the jitted JAX run differs from
# the op-by-op one by up to 0.094 in contrast
COHERENT_TOL = {"contrast_coherent": 0.04, "profile_coherent": 0.2,
                "contrast_incoherent": 1e-3, "profile_incoherent": 2e-3}
# the lens-design demo on the JAX package's draws: RMS tables in um; the CPU
# float32 run of the port is within 5.5e-3 (nominal) and 4.4e-3 (recovered)
LENS_DESIGN_TOL = {"nominal": 0.02, "detuned": 0.02, "recovered": 0.1}
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
F32_FLOPS = 67e12               # H100 SXM, f32 outside the tensor cores
# the first CUDA versions of the kernels (one thread per ray with every
# operation IEEE and separately rounded; one thread per pixel): device ms on
# an NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6
EARLIER_MS = {"K1 main": 0.1576, "K1 chief": 0.0201, "K2 serve": 0.4715}
TRAIN_CONFIG = "configs/dfdp_synthetic_train_512_v5.yml"
# the training phase keeps the config's widths and cuts its length only
TRAIN_CUTS = {"epochs": 1, "synthetic_len": 16, "synthetic_val_len": 2}
REF_DIR = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
KS35 = 35
# the F/1.8 ks-35 serve path; its config names no depth net, so the check
# runs a copy that names the shipped one, as the JAX CPU reference does
F18_CONFIG = "configs/dfdp_f18_farfield_256.yml"
F18_NET = "./ckpt/rf50mm/Sdirt_f18_farfield"
AB_MAE_RTOL = 0.005
DEBLUR_SAMPLE_CONFIG = "configs/dfdp_synthetic_train_128_deblur_cpu.yml"
DEBLUR_NET = "./ckpt/rf50mm/Sdirt_deblur_demo_cpu"
DEBLUR_TRAIN_CONFIG = "configs/dfdp_synthetic_train_256_deblur.yml"
# the 2-focus stack: its second view's 5 m surrogate is not in the repository,
# so the shipped 256-wide F/4 net stands in for it, refocused to 5 m
STACK_CONFIG = "configs/dfdp_f4_2focus_256.yml"
STACK_VIEW2 = {"psfnet_path": "./ckpt/rf50mm/F4_PSFNet_mlp@256",
               "psfnet_model": "mlp@256"}
# the new training paths keep their configs' widths and cut their length:
# 4 steps (synthetic_len = 4 bs) and 2 validation items
NEW_TRAIN_CUTS = {"epochs": 1, "synthetic_val_len": 2}
THIN_LENS = dict(foc_len=50.0, fnum=1.8, kernel_size=21, sensor_size=[24.0, 36.0])
# the same f32 arithmetic on both devices, the taps summed in the same order
THIN_TOL = 1e-5
REAL_CONFIG = "configs/dfdp_by_sdirt_rf50mm.yml"
NYU_TREE = "sdirt_tpu_torch/reference/datasets/nyu2_train"
# cut in length only: 3 epochs run both halves of the schedule (the first
# half, epochs 0-1, on the NYU + 2x FlyingThings3D mix); each training set
# is cut to REAL_STEPS steps by step_view
REAL_CUTS = {"epochs": 3}
REAL_STEPS = 2
FT3D_SCENES = {"FlyingThings3D_train": 4, "FlyingThings3D_test": 2}
FT3D_RES = (540, 960)
PROBE_TOL_PX = 0.01
PROBE_SPP = 200_000             # dp_disparity_probe --traced's rays per point

T0 = time.perf_counter()


def left_s():
    """Seconds left of the budget (at least 1)."""
    return max(1.0, BUDGET_S - (time.perf_counter() - T0))


def _out_of_time(signum, frame):
    raise TimeoutError(f"time budget of {BUDGET_S} s exceeded")


def phase(name, t_start):
    elapsed = time.perf_counter() - t_start
    total = time.perf_counter() - T0
    print(f"[phase {name}] {elapsed:.3f} s (total {total:.3f} s)", flush=True)
    if total > BUDGET_S:
        raise RuntimeError(f"time budget of {BUDGET_S} s exceeded")


def cuda_time_ms(fn, reps, warmup=2):
    """Mean device time of fn() over reps calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(fn, reps):
    """Device time by kernel over reps calls of fn, from torch.profiler's
    CUDA activity: ([(kernel, launches, ms)], busy ms), largest first; an
    empty list when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[2])
    return rows, sum(r[2] for r in rows)


def print_profile(what, rows, busy, reps, wall_ms, top=8):
    """The largest kernels of a profile, per call, and the device's idle
    share against wall_ms per call (CUDA events, outside the profiler)."""
    if not rows:
        print(f"profile {what}: the profiler recorded no device time (not measured)")
        return
    print(f"profile {what}: device busy {busy / reps:.3f} ms per call of "
          f"{wall_ms:.3f} ms (idle share {1 - busy / reps / wall_ms:.1%}), "
          f"{sum(r[1] for r in rows) / reps:.0f} kernels per call; largest:")
    for key, count, ms in rows[:top]:
        print(f"    {ms / reps:9.4f} ms  {count / reps:6.1f}x  {key[:90]}")


def conv_inputs(gen, n, h, w, c, ks):
    img = torch.rand((n, h, w, c), generator=gen, device="cuda")
    psf = torch.rand((ks * ks, n, 2, h * w), generator=gen,
                     device="cuda").to(torch.bfloat16)
    return img, psf


def max_diff(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def k3_agreement(got, want):
    """How far K3's bf16 output lies from its plain version's: (the most
    bf16 ulps between them where the larger lies above 1/256 of the largest
    output, the largest absolute gap, the share of outputs that differ); a
    copy of tests/test_torch_dense_kernel.py:agreement, which has the
    reasons."""
    top = float(want.abs().max())
    worst, gap, differ = 0, 0.0, 0
    for a, r in zip(got.reshape(-1).split(1 << 24), want.reshape(-1).split(1 << 24)):
        a32, r32 = a.float(), r.float()
        ulps = (a.view(torch.int16).int() - r.view(torch.int16).int()).abs()
        worst = max(worst, int(ulps.masked_fill(torch.maximum(a32, r32) < top / 256, 0).max()))
        gap = max(gap, float((a32 - r32).abs().max()))
        differ += int((ulps != 0).sum())
    return worst, gap, differ / want.numel()


def worst_pixel(psf_tm, ks, got, ref):
    """Print where K2 and its plain version differ most: both values, the
    gap in f32 ulps of the value, and that pixel's tap sum as the plain
    version reduces it, in the kernel's order (f32) and exactly (f64)."""
    view = max((0, 1), key=lambda v: float((got[v] - ref[v]).abs().max()))
    g, r = got[view], ref[view]
    n, y, x, c = np.unravel_index(int((g - r).abs().argmax()), tuple(g.shape))
    a, b = float(g[n, y, x, c]), float(r[n, y, x, c])
    ulp = float(np.spacing(np.float32(abs(b))))
    taps = psf_tm[:, n, view, y * g.shape[2] + x].float().cpu().numpy()
    taps = taps.reshape(ks, ks)
    order = taps[:, ::-1] if view == 0 else taps      # the kernel's dx order
    seq = np.float32(0)
    for t in order.ravel():
        seq = np.float32(seq + t)
    print(f"  worst pixel: view {'LR'[view]} n {n} y {y} x {x} c {c}: kernel "
          f"{a!r}, plain {b!r}, gap {abs(a - b):.3e} = {abs(a - b) / ulp:.1f} "
          f"ulp (ulp {ulp:.3e})")
    print(f"  its tap sum: plain f32 {float(psf_tm[:, n, view, y * g.shape[2] + x].float().sum())!r}, "
          f"kernel-order f32 {float(seq)!r}, exact {float(taps.astype(np.float64).sum())!r}; "
          f"{int((taps > 0).sum())} of {ks * ks} taps non-zero, largest {float(taps.max())!r}")


def k2_bound_ms(n, h, w, c, ks):
    """Least time for the function: inputs read once (img f32, PSF bf16),
    outputs written once (two f32 views), or its f32 operations (2 views x
    C multiply-adds + 2 tap sums per tap and pixel), whichever is larger."""
    nbytes = n * h * w * c * 4 + ks * ks * n * 2 * h * w * 2 + 2 * n * h * w * c * 4
    flops = ks * ks * n * h * w * (2 * 2 * c + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k1_bound_ms(n_rays, ops_per_ray):
    """Least time for the trace: 7 f32 read and 4 written per ray, or its
    f32 operations (fused_trace.ops_per_ray, counted from the CUDA source),
    whichever is larger."""
    t_bytes = n_rays * 11 * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = n_rays * ops_per_ray / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k3_reset():
    """Set K3's launch counter to 0 before a main-path run."""
    from sdirt_tpu_torch.render import dense_bf16

    dense_bf16.launches = 0


def k3_record(path, got, want):
    """Keep K3's ``got`` launches on ``path`` beside ``want``, the count its
    renders call for (K3_PER_RENDER)."""
    K3_PATHS[path] = (got, want)
    print(f"K3 launches on the {path} path: {got} (want {want})")


def k3_count(path, want):
    """k3_record of K3's launches since k3_reset()."""
    from sdirt_tpu_torch.render import dense_bf16

    k3_record(path, dense_bf16.launches, want)


def bench_points(rng, n):
    """bench.py's field points: x, y uniform on [-1, 1], depth uniform on
    [-20000, -200] mm."""
    return np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                     -(rng.uniform(0, 1, n) * 19800 + 200)], -1).astype(np.float32)


def k1_contracted_everywhere(rays, d_sensor, plan):
    """K1 launched with n_exact = 0, every surface in the contracted and
    approximate arithmetic: what the plan's exact surfaces buy, measured.
    Calls the C entry point directly, so fused_trace.launches is untouched."""
    import ctypes
    from sdirt_tpu_torch.core.constants import NEWTON_FAST_ITERS
    from sdirt_tpu_torch.dp import fused_trace

    st = fused_trace._Plan.from_buffer_copy(
        fused_trace._plan_arg(plan, NEWTON_FAST_ITERS)._keep)
    st.n_exact = 0
    cols = rays.ra.shape[-1]
    o, d = fused_trace._rows(rays.o, cols), fused_trace._rows(rays.d, cols)
    out = torch.empty((4, *rays.ra.shape), device="cuda")
    rc = fused_trace._kernel()(
        ctypes.addressof(st), o.data_ptr(), o.stride(0), o.stride(1), d.data_ptr(),
        d.stride(0), d.stride(1), rays.ra.data_ptr(), cols, float(np.float32(d_sensor)),
        rays.ra.numel(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_trace_sensor launch failed: CUDA error {rc}")
    return out.unbind(0)


def k1_vs_plain(lens, rng, gen):
    """K1 against its plain version on the same rays and through
    dp_psf_fused with the same pupil samples. Returns (max |px/py diff|,
    max |x_tan diff|, ra mismatches, rays, psf L1 mean, psf L1 max)."""
    from sdirt_tpu_torch.dp import fused_trace
    from sdirt_tpu_torch.dp.psf import dp_psf_fused, lens_scalars, object_points
    from sdirt_tpu_torch.optics.sampling import sample_disk, sample_from_points

    plan = fused_trace.make_fused_plan(lens)
    sc = lens_scalars(lens)
    worst = [0.0, 0.0, 0, 0]
    for spp, n, shrink in ((20000, 64, 1.0), (2048, 64, 0.25), (1999, 37, 1.0)):
        pts = torch.from_numpy(bench_points(rng, n)).cuda()
        rays = sample_from_points(object_points(pts, sc), spp, sc["pupilz"],
                                  sc["pupilr"] * shrink, gen)
        got = fused_trace.fused_trace_sensor(rays, lens.d_sensor, plan)
        ref = fused_trace.fused_trace_sensor_ref(rays, lens.d_sensor, plan)
        torch.cuda.synchronize()
        live = (got[3] > 0) & (ref[3] > 0)
        mism = int((got[3] != ref[3]).sum())
        dxy = max(float((got[i] - ref[i]).abs()[live].max()) for i in (0, 1))
        dxt = float((got[2] - ref[2]).abs()[live].max())
        everywhere = k1_contracted_everywhere(rays, lens.d_sensor, plan)
        mism_all = int((everywhere[3] != ref[3]).sum())
        print(f"  K1 vs plain {spp}x{n} (pupil x{shrink}): live {float(live.float().mean()):.4f}, "
              f"ra mismatches {mism} of {rays.ra.numel()}, max |px/py diff| "
              f"{dxy:.3e} mm, max |x_tan diff| {dxt:.3e}; contracted through the "
              f"stop as well: {mism_all} ra mismatches")
        if not (dxy <= K1_PXY_TOL and dxt <= K1_XTAN_TOL
                and mism <= K1_RA_MISMATCH * rays.ra.numel()):
            raise RuntimeError(f"K1 disagrees with its plain version at {spp}x{n}")
        worst = [max(worst[0], dxy), max(worst[1], dxt), worst[2] + mism,
                 worst[3] + rays.ra.numel()]
    pts = torch.from_numpy(bench_points(rng, 64)).cuda()
    xy_main = sample_disk(gen, (20000,), sc["pupilr"], "cuda")
    xy_chief = sample_disk(gen, (2048,), sc["pupilr"] * 0.25, "cuda")
    psfs = [dp_psf_fused(pts, None, sc, plan, spp=20000, spp_chief=2048, ks=KS,
                         pupil_main=xy_main, pupil_chief=xy_chief, trace=trace)
            for trace in (None, fused_trace.fused_trace_sensor_ref)]
    l1 = torch.stack([(a - b).abs().mean((-1, -2)) for a, b in zip(*psfs)])
    l1_mean, l1_max = float(l1.mean()), float(l1.max())
    print(f"  PSF via dp_psf_fused, K1 vs plain, 64 points x 20000 rays: "
          f"L1 mean {l1_mean:.3e}, max {l1_max:.3e}")
    if not (l1_mean <= PSF_L1_MEAN_TOL and l1_max <= PSF_L1_MAX_TOL):
        raise RuntimeError("K1's PSFs disagree with the plain version's")
    return (*worst, l1_mean, l1_max)


PROBE_FIELDS = ("path", "newton", "has_c", "n_ai", "loose", "tight", "vrule", "skip")
# The plain version's arithmetic on every surface, for the probes: Exact's
# separately rounded operations with the polished solves IEEE as well.
PROBE_IEEE = r"""
struct Ieee {
  float v;
  __device__ Ieee(float x = 0.0f) : v(x) {}
};
__device__ __forceinline__ Ieee operator+(Ieee a, Ieee b) { return __fadd_rn(a.v, b.v); }
__device__ __forceinline__ Ieee operator-(Ieee a, Ieee b) { return __fsub_rn(a.v, b.v); }
__device__ __forceinline__ Ieee operator*(Ieee a, Ieee b) { return __fmul_rn(a.v, b.v); }
__device__ __forceinline__ Ieee operator-(Ieee a) { return -a.v; }
__device__ __forceinline__ bool operator<(Ieee a, Ieee b) { return a.v < b.v; }
__device__ __forceinline__ bool operator>(Ieee a, Ieee b) { return a.v > b.v; }
__device__ __forceinline__ bool operator<=(Ieee a, Ieee b) { return a.v <= b.v; }
__device__ __forceinline__ bool operator>=(Ieee a, Ieee b) { return a.v >= b.v; }
__device__ __forceinline__ float value(Ieee x) { return x.v; }
__device__ __forceinline__ Ieee abs_(Ieee x) { return fabsf(x.v); }
__device__ __forceinline__ Ieee rcp(Ieee x) { return __frcp_rn(x.v); }
__device__ __forceinline__ Ieee sqrt_(Ieee x) { return __fsqrt_rn(x.v); }
namespace {  // where fused_trace.cu declares the solve helpers
template <> __device__ Ieee seed_sqrt<Ieee>(Ieee x) { return __fsqrt_rn(x.v); }
template <> __device__ Ieee half_rcp<Ieee>(Ieee x) { return __fdiv_rn(0.5f, x.v); }
template <> __device__ Ieee step_div<Ieee>(Ieee f, Ieee df) { return __fdiv_rn(f.v, df.v); }
}  // namespace
#define LOAD float* p = io + 7 * (blockIdx.x * blockDim.x + threadIdx.x); \
  Ray r{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
#define STORE p[0] = r.ox; p[1] = r.oy; p[2] = r.oz; p[3] = r.dx; p[4] = r.dy; \
  p[5] = r.dz; p[6] = r.ra;
extern "C" __global__ void probe_base(const __grid_constant__ Plan plan, float* io) { LOAD STORE }
extern "C" __global__ void probe_sensor(const __grid_constant__ Plan plan, float* io) {
  LOAD float px, py, xt; to_sensor(r, plan.s[0].d, px, py, xt);
  r.ox = px; r.oy = py; r.oz = xt; STORE }
"""


def k1_surface_kinds(plan, mode):
    """Per surface of a plan, its probe key: the flags of csrc/fused_trace.cu
    Surf and the scalar type it is traced in ('Ieee' for the plain version's
    arithmetic everywhere, else as the kernel does)."""
    from sdirt_tpu_torch.dp import fused_trace

    n_exact = fused_trace.exact_surfaces(plan)
    return [tuple(s[k] for k in PROBE_FIELDS)
            + ("Ieee" if mode == "plain" else ("Exact" if i < n_exact else "float"),)
            for i, s in enumerate(fused_trace._surface_table(plan))]


def start_k1_probes(plans, build_dir):
    """Write and start compiling (nvcc -cubin, in the background) one probe
    kernel per surface kind of the plans: it traces one ray through one
    surface with the flags compiled in, so its SASS is that kind's
    instructions per ray. Returns (process, cubin, {key: kernel name})."""
    from sdirt_tpu_torch.core.constants import NEWTON_FAST_ITERS
    from sdirt_tpu_torch.utils import kernels

    keys = sorted({k for plan in plans for mode in ("plain", "shipped")
                   for k in k1_surface_kinds(plan, mode)})
    names = {k: f"probe_{i}" for i, k in enumerate(keys)}
    lines = [f'#include "{os.path.join(kernels.CSRC, "fused_trace.cu")}"', PROBE_IEEE]
    for k, name in names.items():
        sets = " ".join(f"s.{f} = {v};" for f, v in zip(PROBE_FIELDS, k[:-1]))
        lines.append(f'extern "C" __global__ void {name}(const __grid_constant__ Plan plan, '
                     f"float* io) {{ LOAD Surf s = plan.s[0]; {sets} "
                     f"trace_surface<{k[-1]}>(s, {NEWTON_FAST_ITERS}, r); STORE }}")
    os.makedirs(build_dir, exist_ok=True)
    src = os.path.join(build_dir, "fused_trace_probes.cu")
    with open(src, "w") as f:
        f.write("\n".join(lines) + "\n")
    cubin = os.path.join(build_dir, "fused_trace_probes.cubin")
    proc = subprocess.Popen([kernels.nvcc(), *kernels.ARCH_FLAGS, "-cubin", "-o", cubin, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, cubin, names


def k1_sass_report(plans, probes):
    """Print K1's SASS: the built kernel's static count, and per ray, for
    each lens, the probes' fast paths summed over its surfaces, with the
    plain version's arithmetic everywhere and as shipped. Returns
    {lens: (plain per ray, shipped per ray)} instruction totals."""
    from sdirt_tpu_torch.utils import kernels, sass

    proc, cubin, names = probes
    out, _ = proc.communicate(timeout=left_s())
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on K1's probes:\n{out}")
    for fn, ins in sass.parse(sass.cuobjdump(kernels.lib_paths["fused_trace"])).items():
        print(f"SASS {fn[-40:]} (static, whole kernel): {sass.summary(sass.static_counts(ins))}")
    funcs = {f: sass.fast_path(ins) for f, ins in sass.parse(sass.cuobjdump(cubin)).items()}
    base = funcs["probe_base"]
    per_kind = {k: funcs[name] - base for k, name in names.items()}
    sensor = funcs["probe_sensor"] - base
    totals = {}
    for lens_name, plan in plans.items():
        totals[lens_name] = []
        for mode in ("plain", "shipped"):
            per_ray = collections.Counter(sensor)
            kinds = k1_surface_kinds(plan, mode)
            for k in sorted(set(kinds)):
                per_ray.update({op: n * kinds.count(k) for op, n in per_kind[k].items()})
                print(f"  K1 SASS {lens_name} {mode}: path {k[0]} ({k[-1]}) x{kinds.count(k)}: "
                      f"{sass.summary(per_kind[k])}")
            print(f"K1 SASS per ray {lens_name}, {mode} arithmetic: {sass.summary(per_ray)}")
            totals[lens_name].append(per_ray["total"])
    return totals


def mean_after_first(values):
    """Mean of the steps after the first (which pays for cuDNN's algorithm
    search and the loader's start), or of the one step there is."""
    return float(np.mean(values[1:] if len(values) > 1 else values))


def cut_config(path, out_dir, train=None, test=None, **overrides):
    """The config at ``path`` with ``overrides``, and ``train`` / ``test``
    merged into its sides, written under out_dir."""
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    cfg.update(overrides)
    for side, extra in (("train", train), ("test", test)):
        if extra:
            cfg[side] = {**cfg[side], **extra}
    cut = os.path.join(out_dir, os.path.basename(path))
    with open(cut, "w") as f:
        yaml.safe_dump(cfg, f)
    return cut, cfg


def training_phase(dfdp_net, fused_conv, smi):
    """Phase 9: the training path through dfdp_net.main(); returns its
    figures for the kernels line."""
    from sdirt_tpu_torch.dfdp.datasets import DataLoader
    from sdirt_tpu_torch.dfdp.train import create_dfdp_state, dfdp_train_step
    from sdirt_tpu_torch.render.camera import degamma
    from sdirt_tpu_torch.render.mlp_fast import mlp_psf_tapmajor
    from sdirt_tpu_torch.render.pipeline import query_points

    with tempfile.TemporaryDirectory() as tmp:
        cfg_path, cfg = cut_config(TRAIN_CONFIG, tmp, **TRAIN_CUTS,
                                   ckpt_out=os.path.join(tmp, "best"),
                                   train_state_dir=os.path.join(tmp, "state"))
        bs, res = cfg["bs"], tuple(cfg["res"])
        full = dfdp_net.load_config(TRAIN_CONFIG)
        print(f"training: {TRAIN_CONFIG} at {res[0]}x{res[1]}, bs {bs}, style "
              f"{cfg['synthetic_style']}, lr {cfg['lr']}, ks {cfg['ks']}, warm start "
              f"{cfg['train']['dfdpnet_pretrained']}; cut in length only: {TRAIN_CUTS} "
              f"(the config's: { {k: full[k] for k in TRAIN_CUTS} })")
        argv = ["--stage", "train", "--config", cfg_path, "--device", "cuda",
                "--out", os.path.join(tmp, "results")]
        fused_conv.launches = 0
        k3_reset()
        torch.cuda.reset_peak_memory_stats()
        t_main = time.perf_counter()
        res1 = dfdp_net.main(argv)
        main_s = time.perf_counter() - t_main
        k2 = fused_conv.launches
        k3_count("train", K3_PER_RENDER["fused"] * k2)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        losses = np.array(res1["losses"])
        n_steps = TRAIN_CUTS["synthetic_len"] // bs
        want = n_steps + 2 * TRAIN_CUTS["synthetic_val_len"]
        print(f"K2 launches on the training path: {k2} (steps {len(losses)} + 2 "
              f"validations x {TRAIN_CUTS['synthetic_val_len']} items = {want})")
        if len(losses) != n_steps or k2 != want:
            raise RuntimeError("the training path did not launch K2 once per step "
                               "and validation item")
        if not np.isfinite(losses).all():
            raise RuntimeError(f"non-finite training loss: {losses}")
        steps = res1["steps"]
        render_ms = [s["render_ms"] for s in steps]
        step_ms = [s["train_step_ms"] for s in steps]
        wait_s = [s["data_wait_s"] for s in steps]
        pairs_s = bs * n_steps / res1["epoch_seconds"][0]
        print(f"train losses {losses.round(6).tolist()}; validation acc1 "
              f"{[round(v['acc1'], 4) for v in res1['val']]}; main() {main_s:.1f} s")
        for i, s in enumerate(steps):
            print(f"  step {i}: data wait {s['data_wait_s'] * 1e3:.1f} ms, render "
                  f"{s['render_ms']:.3f} ms, train step {s['train_step_ms']:.3f} ms")
        print(f"per training step (mean after the first, CUDA events): render "
              f"{mean_after_first(render_ms):.3f} ms, DDDNet train step "
              f"{mean_after_first(step_ms):.3f} ms, host data wait "
              f"{mean_after_first(wait_s) * 1e3:.1f} ms; epoch loop "
              f"{res1['epoch_seconds'][0]:.3f} s for {n_steps} steps: {pairs_s:.3f} "
              f"pairs/s; max_memory_allocated {peak_gb:.2f} GiB ({smi})")

        export = dfdp_net.ported_weights(cfg["ckpt_out"])
        net = dfdp_net.build_basenet(export, device="cuda")
        depth = {}
        for tag, ds in zip(("box", "f2d", "casual"),
                           dfdp_net.get_depth_sample_set(dfdp_net.load_config(TRAIN_CONFIG))):
            depth[tag] = dfdp_net.test_depth(net, ds, torch.device("cuda"))
            if not all(np.isfinite(v) for v in depth[tag].values()):
                raise RuntimeError(f"the exported net's {tag} depth is not finite")
        print("exported best net in the --stage sample depth part: "
              + "; ".join(f"{k} mae {v['mae']:.4f} acc1 {v['acc1']:.4f}"
                          for k, v in depth.items()))
        del net

        res2 = dfdp_net.main(argv)
        print(f"resume rerun: start epoch {res2['start_epoch']}, epochs trained "
              f"{res2['epochs_trained']}, steps {len(res2['losses'])}")
        if res2["start_epoch"] != TRAIN_CUTS["epochs"] or res2["losses"]:
            raise RuntimeError("the resumed run trained a step")

    # a profiled loop of training steps as train() runs them, data included,
    # after one warm-up step of the same loader
    args = dfdp_net.load_config(TRAIN_CONFIG)
    args.update(TRAIN_CUTS, synthetic_len=bs * (n_steps + 1))
    train_lens, _ = dfdp_net.get_lens(args, device="cuda")
    train_set = dfdp_net.get_dataset(args)[0]
    state = create_dfdp_state(dfdp_net.build_basenet(dfdp_net.ported_weights(
        args["train"]["dfdpnet_pretrained"]), device="cuda", train=True),
        args["lr"], n_steps)
    gen = torch.Generator(device="cuda").manual_seed(1)
    batches = iter(DataLoader(train_set, batch_size=bs, shuffle=True,
                              num_workers=4, drop_last=True, seed=0))

    def loop(n):
        for _ in range(n):
            stack, depth_dev, _ = dfdp_net._render_batch(train_lens, *next(batches),
                                                         gen, train=True)
            dfdp_train_step(state, stack, depth_dev)
        torch.cuda.synchronize()

    loop(1)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_loop = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        loop(n_steps)
    loop_ms = (time.perf_counter() - t_loop) * 1e3
    rows = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    idle = 1 - busy / loop_ms if rows else None
    print_profile(f"training loop ({n_steps} steps after a warm-up step, data "
                  "included)", rows, busy, n_steps, loop_ms / n_steps, top=10)

    # K2 and its plain version on a training batch's PSF
    aif, gt = next(iter(DataLoader(train_set, batch_size=bs, num_workers=4)))
    with torch.no_grad():
        depth_mm = -torch.from_numpy(gt).cuda() * 1e3
        o = query_points(depth_mm, train_lens.d_sensor, train_lens.d_min, train_lens.d_max)
        psf_tm = mlp_psf_tapmajor(train_lens.net, o, KS)
        lum = degamma(torch.from_numpy(aif).cuda().permute(0, 2, 3, 1)).contiguous()
        got = fused_conv.fused_dp_conv_tapmajor(lum, psf_tm, KS)
        ref = fused_conv.fused_dp_conv_tapmajor_ref(lum, psf_tm, KS)
        k2_err = max_diff(got, ref)
        del got, ref
        if not k2_err <= KERNEL_TOL:
            raise RuntimeError("K2 disagrees with its plain version on a training batch")
        k2_ms = cuda_time_ms(lambda: fused_conv.fused_dp_conv_tapmajor(lum, psf_tm, KS), 20)
        plain_ms = cuda_time_ms(
            lambda: fused_conv.fused_dp_conv_tapmajor_ref(lum, psf_tm, KS), 2, 1)
    k2_shape = list(lum.shape)
    bound_ms, bound_by = k2_bound_ms(*k2_shape, KS)
    print(f"K2 at the training shape {tuple(k2_shape)}: {k2_ms:.4f} ms per launch "
          f"(bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / k2_ms:.1%} of it); plain "
          f"{plain_ms:.3f} ms; K2 vs plain on the batch's PSF {k2_err:.3e}")
    del psf_tm, lum, o, state
    torch.cuda.empty_cache()
    return {"k2_launches": k2, "steps": n_steps, "losses": losses.tolist(),
            "render_ms": mean_after_first(render_ms),
            "train_step_ms": mean_after_first(step_ms),
            "data_wait_ms": mean_after_first(wait_s) * 1e3,
            "pairs_per_s": pairs_s, "max_memory_allocated_gib": peak_gb,
            "loop_ms_per_step": loop_ms / n_steps, "device_idle_share": idle,
            "k2": {"shape": k2_shape, "ms": k2_ms,
                   "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "max_abs_err": k2_err}}


def train_step_reference(dfdp_net):
    """Phase 10: three train steps of the shipped net at 128x192, bs 2, on
    the stored JAX stacks and on the card's own render, against the JAX
    package's CPU losses. Returns the losses and their worst relative gaps."""
    from sdirt_tpu_torch.dfdp.datasets import SyntheticRGBD
    from sdirt_tpu_torch.dfdp.train import create_dfdp_state, dfdp_train_step

    ref_dir = os.path.join(ROOT, "sdirt_tpu_torch", "reference")
    with open(os.path.join(ref_dir, "train_step_jax_cpu.json")) as f:
        ref = json.load(f)
    with np.load(os.path.join(ROOT, ref["stacks"])) as z:
        stored = [(z["stacks"][k].astype(np.float32) / 65535,
                   z["depths"][k].astype(np.float32)) for k in range(ref["steps"])]
    args = dfdp_net.load_config(ref["config"])
    lens, _ = dfdp_net.get_lens(args, device="cuda")
    ds = SyntheticRGBD(tuple(ref["res"]), style="v5", seed=0)
    bs = ref["bs"]
    out = {"reference": ref["losses"]}
    for mode, rtol in (("stored_stacks", ref["stored_stacks_rtol"]),
                       ("own_render", ref["own_render_rtol"])):
        state = create_dfdp_state(dfdp_net.build_basenet(
            os.path.join(ROOT, ref["weights"]), device="cuda", train=True),
            ref["lr"], ref["total_steps"])
        losses = []
        for k in range(ref["steps"]):
            if mode == "stored_stacks":
                stack, depth = (torch.from_numpy(a).cuda() for a in stored[k])
            else:
                items = [ds[bs * k + j] for j in range(bs)]
                stack, depth, _ = dfdp_net._render_batch(
                    lens, np.stack([i[0] for i in items]), np.stack([i[1] for i in items]))
            losses.append(float(dfdp_train_step(state, stack, depth)["total"]))
        gaps = [abs(a - b) / b for a, b in zip(losses, ref["losses"])]
        print(f"train steps on {mode.replace('_', ' ')}: losses {losses} (JAX CPU "
              f"{ref['losses']}), worst relative gap {max(gaps):.3e} (tolerance {rtol})")
        if not (np.isfinite(losses).all() and max(gaps) <= rtol):
            raise RuntimeError(f"train steps on {mode} off the JAX reference")
        out[mode] = {"losses": losses, "worst_rel_gap": max(gaps)}
    return out


def check_serve_path(lens_name, result, ref):
    """Hold a --stage sample result against the JAX package's CPU run: per
    flat scene (matched by distance) PSNR and the perceptual distance
    (check_flat), per depth set every metric within DEPTH_TOL."""
    ref_flat = {r["distance_mm"]: r for r in ref["flat"]}
    for rec in result["flat"]:
        r = ref_flat[rec["distance_mm"]]
        failed = check_flat(f"{lens_name} flat {rec['distance_mm']} mm", rec, r)
        if failed:
            raise RuntimeError(f"off the JAX reference: {failed}")
        print(f"{lens_name} flat {rec['distance_mm']} mm ssim_l/r: {rec['ssim_l']:.4f} "
              f"{rec['ssim_r']:.4f} (JAX CPU {r['ssim_l']:.4f} {r['ssim_r']:.4f})")
    if len(result["flat"]) != len(ref_flat):
        raise RuntimeError("flat scene count differs from the reference")
    for tag, m in result["depth"].items():
        for k, v in ref["depth"][tag].items():
            d = m[k] - v
            print(f"{lens_name} depth {tag} {k}: {m[k]:.6f} (JAX CPU {v:.6f}, diff {d:+.2e})")
            if not (np.isfinite(m[k]) and abs(d) <= DEPTH_TOL):
                raise RuntimeError(f"{lens_name} depth {tag} {k} off the JAX reference")
    print(f"{lens_name} serve path host seconds: {result['seconds']}")


def check_flat(what, rec, ref):
    """Hold one set of flat scores against the JAX package's: PSNR of both
    views within PSNR_TOL_DB, the perceptual distance within PERC_RTOL.
    Prints each and returns the names of those outside."""
    failed = []
    for k in ("psnr_l", "psnr_r"):
        d = rec[k] - ref[k]
        print(f"{what} {k}: {rec[k]:.4f} dB (JAX CPU {ref[k]:.4f}, diff {d:+.4f})")
        if not (np.isfinite(rec[k]) and abs(d) <= PSNR_TOL_DB):
            failed.append(f"{what} {k}")
    for k in ("perc_l", "perc_r"):
        rel = rec[k] / ref[k] - 1
        print(f"{what} {k}: {rec[k]:.5f} (JAX CPU {ref[k]:.5f}, {rel:+.2%})")
        if not (np.isfinite(rec[k]) and abs(rel) <= PERC_RTOL):
            failed.append(f"{what} {k}")
    return failed


def mean_scores(records):
    keys = ("psnr_l", "psnr_r", "ssim_l", "ssim_r", "perc_l", "perc_r")
    return {k: float(np.mean([r[k] for r in records])) for k in keys}


def gate_rows(gate, fused_conv, lens_name, net, jax_rows):
    """The variant gate's rows of one lens and surrogate on the card, each
    held against the JAX package's CPU rows: the scan of the same net, or,
    where the JAX CPU run of the row's own variant is itself outside
    PSNR_TOL_DB of that scan, its own variant (and that run in any case
    where it exists). Returns the rows, the K2 launches of the gate's whole
    run and the checks that failed."""
    argv = ["--config", f"configs/dfdp_by_sdirt_{lens_name}.yml", "--device", "cuda",
            *GATE_ROWS[net]]
    if net != "mlp":
        argv += ["--model", net, "--psfnet", f"./ckpt/{lens_name}/F4_PSFNet_{net}"]
    fused_conv.launches = 0
    rows = gate.main(argv)
    launches = fused_conv.launches
    scan = jax_rows[f"{net}/scan"]
    failed = []
    for r in rows:
        variant = r["variant"]
        what = f"{lens_name} {net} {variant}"
        same = jax_rows.get(f"{net}/{variant}") if variant != "scan" else None
        refs = [("JAX CPU scan", scan)]
        if same is not None:
            own = [same[k] - scan[k] for k in ("psnr_l", "psnr_r")]
            print(f"{what}: the JAX CPU {variant} itself is {own[0]:+.4f} / "
                  f"{own[1]:+.4f} dB from its scan")
            if max(map(abs, own)) > PSNR_TOL_DB:
                d = [r[k] - scan[k] for k in ("psnr_l", "psnr_r")]
                print(f"{what} vs the JAX CPU scan (not gated: the variant itself "
                      f"misses it): {d[0]:+.4f} / {d[1]:+.4f} dB")
                refs = []
            refs.append((f"JAX CPU {variant}", same))
        for name, ref in refs:
            failed += check_flat(f"{what} vs {name}", r, ref)
        print(f"{what}: K2 launches {r['k2_launches']}")
        if (r["k2_launches"] > 0) != variant.startswith("fused"):
            failed.append(f"{what}: K2 launched {r['k2_launches']} times")
        # one render per view and scene
        k3_record(f"gate {what}", r["k3_launches"],
                  K3_PER_RENDER.get(variant, 0) * 2 * len(r["flat"]))
    return rows, launches, failed


def k3_layers(nets, o):
    """K3 (render/dense_bf16.py) layer by layer through each net's bf16
    chain (the PSF MLP's 10 trunk layers and its tap-major head; the basis
    student's 11 coefficient layers) at 4 x 2 x 512 x 768 rows, the
    training render's: each layer's K3 time (CUDA events) beside its bound
    (the larger of bf16 bytes at 3.35 TB/s and bf16 FLOPs at 989 TFLOP/s),
    its plain version's time and the library's fused route's
    (torch._addmm_activation: cuBLASLt's bias + ReLU epilogue, the bias
    rounded to bf16 first; the port does not call it), on the same input,
    the previous K3 layer's output. The epilogue adds its bias along the
    output's columns, so at the tap-major head the library is timed
    writing [rows, taps]: the same bytes and FLOPs in the other layout.
    Raises where K3 and the plain version are more than one bf16 ulp apart
    away from the ReLU's zero, more than one ulp of the layer's largest
    output near it, or differ on 1% of the outputs (k3_agreement).
    Returns {net: [per-layer records]}. Calls K3 directly, outside any path
    K3_PATHS counts."""
    from sdirt_tpu_torch.render import dense_bf16, mlp_fast

    x = mlp_fast.stack_views(o.expand(4, *o.shape[1:]).contiguous()).to(torch.bfloat16)
    out = {}
    for name, (net, head) in nets.items():
        layers = [(w.to(torch.bfloat16), b) for w, b in mlp_fast.dense_layers(net)]
        layers = layers if head else layers[:-1]
        h, rows, recs = x, x.shape[0], []
        for i, (w, b) in enumerate(layers):
            tm = head and i == len(layers) - 1
            n, k = w.shape
            k3_ms = cuda_time_ms(lambda: dense_bf16.dense_relu(h, w, b, tapmajor=tm), 10)
            plain_ms = cuda_time_ms(lambda: dense_bf16.dense_relu_ref(h, w, b, tapmajor=tm), 3)
            b16 = b.to(torch.bfloat16)
            library_ms = cuda_time_ms(lambda: torch._addmm_activation(b16, h, w.t()), 10)
            got = dense_bf16.dense_relu(h, w, b, tapmajor=tm)
            want = dense_bf16.dense_relu_ref(h, w, b, tapmajor=tm)
            top = float(want.abs().max())
            worst, gap, share = k3_agreement(got, want)
            kp = -(-k // dense_bf16.ALIGN) * dense_bf16.ALIGN
            byts = rows * (kp + n) * 2 + n * kp * 2 + n * 4
            flops = 2 * rows * k * n
            bound = max(byts / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
            by = "bytes" if byts / HBM_BYTES_PER_S >= flops / BF16_FLOPS else "FLOPs"
            print(f"  K3 {name} layer {i} {k}->{n}{' tap-major' if tm else ''} at {rows} "
                  f"rows: {k3_ms:.4f} ms (bound {bound:.4f} ms by {by}, "
                  f"{100 * bound / k3_ms:.1f}%), plain {plain_ms:.4f} ms, library "
                  f"{library_ms:.4f} ms{' (row-major)' if tm else ''}; "
                  f"{worst} ulp away from zero, gap {gap:.3e} of {top:.3e}, "
                  f"{share:.2e} of outputs differ")
            if worst > 1 or gap > top * 2.0 ** -8 or share >= 0.01:
                raise RuntimeError(f"K3 disagrees with its plain version at {name} layer {i}")
            recs.append({"k": k, "n": n, "tapmajor": tm, "ms": k3_ms, "plain_ms": plain_ms,
                         "library_ms": library_ms,
                         "bound_ms": bound, "bound_by": by, "max_ulps": worst,
                         "max_abs_gap": gap, "share_differ": share})
            h = got
            del want
        total = sum(r["ms"] for r in recs)
        print(f"  K3 {name}: {len(recs)} layers {total:.3f} ms (bound "
              f"{sum(r['bound_ms'] for r in recs):.3f} ms, plain "
              f"{sum(r['plain_ms'] for r in recs):.3f} ms, library "
              f"{sum(r['library_ms'] for r in recs):.3f} ms)")
        out[name] = recs
        del h
    return out


def variant_times(dfdp_net, fused_conv, smi):
    """Render-call time (CUDA events, after warm-up) and peak memory of each
    variant on both lenses at 512x768, and at rf50mm the parts: the bf16 and
    int8 trunks, the PSF MLP, the basis coefficient MLP, its conv and
    contraction; K2 against its plain version on the fused_int8 path's PSF
    and the int8 trunk on the card against the CPU. Returns the figures."""
    from sdirt_tpu_torch.render import basis, mlp_fast
    from sdirt_tpu_torch.render.camera import degamma
    from sdirt_tpu_torch.render.pipeline import get_quant, query_points

    out = {"render": {}}
    for lens_name in ("rf50mm", "rf35mm"):
        args = dfdp_net.load_config(f"configs/dfdp_by_sdirt_{lens_name}.yml")
        _, mlp_lens = dfdp_net.get_lens(args, device="cuda")
        args["test"].update(psfnet_model=BASIS_NET,
                            psfnet_path=f"./ckpt/{lens_name}/F4_PSFNet_{BASIS_NET}")
        _, basis_lens = dfdp_net.get_lens(args, device="cuda")
        f4, f20, depth = dfdp_net.get_flat_sample_set(args)[0]
        img = torch.from_numpy(f20[None, :3]).cuda()
        dist = torch.from_numpy(-depth[None] * 1e3).cuda()
        for lens, variants in ((mlp_lens, ("fused", "fused_int8", "scan", "scan_f32")),
                               (basis_lens, ("scan", "basis", "basis_int8"))):
            for v in variants:
                kw = ({"variant": "scan", "mlp_bf16": False} if v == "scan_f32"
                      else {"variant": v})
                call = lambda: lens.render(img, dist, None, **kw)  # noqa: E731
                ms = cuda_time_ms(call, 5)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                call()
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - base) / 2**30
                key = f"{lens_name} {lens.model_name} {v}"
                out["render"][key] = {"ms": ms, "peak_gib": peak}
                print(f"render call {key} at {img.shape[-2]}x{img.shape[-1]}: {ms:.3f} ms, "
                      f"peak memory "
                      f"{peak:.3f} GiB above the {base / 2**30:.3f} GiB held ({smi})")
                if lens_name == "rf50mm":
                    print_profile(f"render call {key}", *device_profile(call, 3), 3, ms,
                                  top=6)
        if lens_name != "rf50mm":
            continue
        with torch.no_grad():
            o = query_points(dist, mlp_lens.d_sensor, mlp_lens.d_min, mlp_lens.d_max)
            lum = degamma(img.permute(0, 2, 3, 1)).contiguous()
            net = mlp_lens.net
            t = time.perf_counter()
            mlp_fast.quantize_mlp(net)
            quant_s = time.perf_counter() - t
            quant = get_quant(net)
            layers = mlp_fast.dense_layers(net)
            x = mlp_fast.stack_views(o)
            rows = x.shape[0]
            parts = {
                "bf16 trunk (layers 0-9)": lambda: mlp_fast.bf16_trunk(layers[:-1], x),
                "int8 trunk (layers 0-9)": lambda: mlp_fast.quant_trunk(layers, quant, x),
                "PSF MLP bf16": lambda: mlp_fast.mlp_psf_tapmajor(net, o, KS),
                "PSF MLP int8": lambda: mlp_fast.mlp_psf_tapmajor(net, o, KS, quant=quant)}
            bnet = basis_lens.net
            bquant = get_quant(bnet)
            kdim = bnet.basis_k
            n, h, w, c = lum.shape
            pad = (KS - 1) // 2
            g_img = torch.nn.functional.pad(lum.permute(0, 3, 1, 2).reshape(n * c, 1, h, w),
                                            (pad, pad, pad, pad), mode="replicate")
            bank = torch.rand((2 * kdim + 2, 1, KS, KS), device="cuda")
            g = basis._conv_bank(g_img, bank, torch.bfloat16).reshape(n, c, 2 * kdim + 2, h, w)
            coeff = basis.basis_coeffs(bnet, o).reshape(n, 2, h, w, kdim).to(
                torch.bfloat16).permute(0, 1, 4, 2, 3)
            parts.update({
                "basis coefficient MLP bf16": lambda: basis.basis_coeffs(bnet, o),
                "basis coefficient MLP int8": lambda: basis.basis_coeffs(bnet, o, quant=bquant),
                "basis conv (2K+2 = 98 kernels, bf16)":
                    lambda: basis._conv_bank(g_img, bank, torch.bfloat16),
                "basis K-contraction (both views)":
                    lambda: (basis._contract(coeff[:, 0], g[:, :, :kdim]),
                             basis._contract(coeff[:, 1], g[:, :, kdim + 1:2 * kdim + 1])),
                "basis_dp_conv bf16": lambda: basis.basis_dp_conv(bnet, o, lum, KS),
                "basis_dp_conv int8": lambda: basis.basis_dp_conv(bnet, o, lum, KS,
                                                                  quant=bquant)})
            part_ms = {k: cuda_time_ms(fn, 5) for k, fn in parts.items()}
            k3 = k3_layers({"mlp": (net, True), BASIS_NET: (bnet, False)}, o)
            width = layers[2][0].shape[0]
            trunk_ops = 2 * rows * width * width * len(quant["wq"])
            bflops = 2 * rows * sum(w.numel() for w, _ in mlp_fast.dense_layers(bnet)[:-1])
            conv_flops = 2 * n * c * h * w * (2 * kdim + 2) * KS * KS
            for k, ms in part_ms.items():
                print(f"  part {k}: {ms:.3f} ms")
            print(f"  the trunk's {len(quant['wq'])} {width}x{width} GEMMs over {rows} rows: "
                  f"{trunk_ops / 1e12:.3f} TOP, bound {trunk_ops / BF16_FLOPS * 1e3:.3f} ms "
                  f"in bf16, {trunk_ops / INT8_OPS * 1e3:.3f} ms in int8; quantize_mlp "
                  f"{quant_s:.3f} s of host time once per net and weight state")
            print(f"  basis coefficient MLP: {bflops / 1e12:.3f} TFLOP (bound "
                  f"{bflops / BF16_FLOPS * 1e3:.3f} ms); conv {conv_flops / 1e12:.3f} TFLOP "
                  f"(bound {conv_flops / BF16_FLOPS * 1e3:.3f} ms), output "
                  f"{g.numel() * 2 / 1e6:.1f} MB of bf16")
            del g, coeff, g_img
            # the int8 path on the card against the CPU, on 32768 of the
            # pixels: the int8 products are exact on both, but layer 1's f32
            # sums are taken in another order, so a few activations round
            # to the neighbouring int8 step; held at the PSF, in the JAX
            # package's bf16 band (tests/test_fused_render.py)
            sub = o.reshape(1, -1, 3)[:, ::max(1, rows // 65536)][:, :32768]
            cpu_net = copy.deepcopy(net).cpu()
            cpu_quant = {k: [t.cpu() for t in v] for k, v in quant.items()}
            trunks = [mlp_fast.quant_trunk(mlp_fast.dense_layers(m), q, mlp_fast.stack_views(p))
                      for m, q, p in ((net, quant, sub), (cpu_net, cpu_quant, sub.cpu()))]
            flips = int((trunks[0].cpu() != trunks[1]).sum())
            psfs = [mlp_fast.mlp_psf_pixelmajor(m, p, KS, quant=q).cpu()
                    for m, q, p in ((net, quant, sub), (cpu_net, cpu_quant, sub.cpu()))]
            trunk_diff = float((psfs[0] - psfs[1]).abs().max())
            print(f"  int8 path, card vs CPU on {sub.shape[1]} pixels x 2 views: trunk "
                  f"activations that differ {flips} of {trunks[1].numel()}; normalised "
                  f"PSF max |diff| {trunk_diff:.3e} (tolerance 5e-3)")
            if not trunk_diff <= 5e-3:
                raise RuntimeError("the int8 path on the card disagrees with the CPU")
            del trunks, psfs, cpu_net
            # K2 on the fused_int8 path's PSF
            psf_tm = mlp_fast.mlp_psf_tapmajor(net, o, KS, quant=quant)
            got = fused_conv.fused_dp_conv_tapmajor(lum, psf_tm, KS)
            ref = fused_conv.fused_dp_conv_tapmajor_ref(lum, psf_tm, KS)
            k2_err = max_diff(got, ref)
            del got, ref
            if not k2_err <= KERNEL_TOL:
                raise RuntimeError("K2 disagrees with its plain version on the int8 PSF")
            k2_ms = cuda_time_ms(lambda: fused_conv.fused_dp_conv_tapmajor(lum, psf_tm, KS), 20)
            bound_ms, bound_by = k2_bound_ms(n, h, w, c, KS)
            print(f"K2 on the fused_int8 PSF {tuple(lum.shape)}: {k2_ms:.4f} ms per launch "
                  f"(bound {bound_ms:.4f} ms by {bound_by}); vs plain {k2_err:.3e}")
            out.update(parts_ms=part_ms, trunk_card_vs_cpu=trunk_diff, k3=k3,
                       k2_int8={"ms": k2_ms, "max_abs_err": k2_err, "bound_ms": bound_ms})
            del psf_tm, o, lum, x
        del mlp_lens, basis_lens
        torch.cuda.empty_cache()
    return out


def k2_ks35(fused_conv, kernels):
    """Phase 13: K2 at ks 35 against its plain version at the F/1.8 serve
    shape, the A/B's training-batch shape and a ragged one; its time, bound
    and shared memory per block at 1 x 256 x 384 and 4 x 256 x 384."""
    smem = kernels.library("fused_dp_conv").fused_dp_conv_smem_bytes(3, KS35)
    print(f"K2 shared memory per block, C 3, ks {KS35}: {smem} B "
          f"({smem / 1024:.1f} KB; 3 blocks take {3 * smem / 1024:.1f} of 228 KB)")
    if smem != fused_conv.smem_bytes(3, KS35) or 3 * smem > 228 * 1024:
        raise RuntimeError("K2's tile at ks 35 does not fit 3 blocks per SM")
    gen = torch.Generator(device="cuda").manual_seed(35)
    out = {"smem_bytes": smem, "max_abs_err": 0.0}
    for shape in ((1, 256, 384, 3), (4, 256, 384, 3), (1, 250, 379, 3)):
        img, psf = conv_inputs(gen, *shape, KS35)
        got = fused_conv.fused_dp_conv_tapmajor(img, psf, KS35)
        ref = fused_conv.fused_dp_conv_tapmajor_ref(img, psf, KS35)
        diff = max_diff(got, ref)
        out["max_abs_err"] = max(out["max_abs_err"], diff)
        print(f"K2 vs plain {shape} ks {KS35}: max |diff| {diff:.3e}")
        if not diff <= KERNEL_TOL:
            raise RuntimeError(f"K2 disagrees with its plain version at {shape}, ks 35")
        del got, ref
        if shape[1:] == (256, 384, 3):
            ms = cuda_time_ms(lambda: fused_conv.fused_dp_conv_tapmajor(img, psf, KS35), 50)
            plain = cuda_time_ms(
                lambda: fused_conv.fused_dp_conv_tapmajor_ref(img, psf, KS35), 2, 1)
            bound, by = k2_bound_ms(*shape, KS35)
            print(f"K2 at {shape}, ks {KS35}: {ms:.4f} ms per launch (bound {bound:.4f} ms "
                  f"by {by}, {bound / ms:.1%} of it); plain {plain:.3f} ms")
            out[f"{shape[0]}x256x384"] = {"ms": ms, "plain_ms": plain,
                                          "bound_ms": bound, "bound_by": by}
        del img, psf
    torch.cuda.empty_cache()
    return out


def render_call_ms(dfdp_net, cfg_path, smi, what):
    """Time (CUDA events, after warm-up) and peak memory of one render call
    of the config's test lens on its first flat sample scene."""
    args = dfdp_net.load_config(cfg_path)
    _, lens = dfdp_net.get_lens(args, device="cuda")
    _, f20, depth = dfdp_net.get_flat_sample_set(args)[0]
    img = torch.from_numpy(f20[None, :3]).cuda()
    dist = torch.from_numpy(-depth[None] * 1e3).cuda()
    call = lambda: lens.render(img, dist, None)  # noqa: E731
    ms = cuda_time_ms(call, 5)
    print_profile(f"render call {what}", *device_profile(call, 3), 3, ms, top=6)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    print(f"render call {what} at {img.shape[-2]}x{img.shape[-1]}, ks {lens.kernel_size}: "
          f"{ms:.3f} ms, peak memory {peak:.3f} GiB above the held ({smi})")
    return {"ms": ms, "peak_gib": peak}


def serve_f18(dfdp_net, fused_conv, smi):
    """Phase 14: the F/1.8 ks-35 serve path through dfdp_net.main() on the
    copy of its config that names the shipped depth net, held against the
    JAX package's CPU run."""
    with open(os.path.join(REF_DIR, "stage_sample_f18_jax_cpu.json")) as f:
        ref = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path, _ = cut_config(F18_CONFIG, tmp, train={"dfdpnet_pretrained": F18_NET})
        fused_conv.launches = 0
        k3_reset()
        result = dfdp_net.main(["--stage", "sample", "--config", cfg_path, "--device",
                                "cuda", "--out", os.path.join(tmp, "out")])
        launches = fused_conv.launches
        k3_count("serve_f18", K3_PER_RENDER["fused"] * launches)
        print(f"K2 launches on the F/1.8 serve path: {launches}")
        if launches <= 0:
            raise RuntimeError("the F/1.8 serve path did not launch K2")
        check_serve_path("f18", result, ref)
        render = render_call_ms(dfdp_net, cfg_path, smi, "F/1.8 fused")
    return {"launches": launches, "render": render}


def farfield_ab(fused_conv):
    """Phase 15: python -m sdirt_tpu_torch.eval_farfield_ab, both arms on 16
    v2 scenes at 256x384, held against the JAX script's CPU table."""
    from sdirt_tpu_torch import eval_farfield_ab

    with open(os.path.join(REF_DIR, "eval_farfield_ab_jax_cpu.json")) as f:
        ref = json.load(f)["full"]
    argv = ["--device", "cuda", *ref["argv"]]
    fused_conv.launches = 0
    k3_reset()
    rows = eval_farfield_ab.main(argv)
    launches = fused_conv.launches
    k3_count("farfield_ab", K3_PER_RENDER["fused"] * launches)
    failed = []
    for r in rows:
        want = ref["arms"][r["name"]]
        for k in ("acc1", "far_acc1", "near_acc1", "mae", "far_mae"):
            d = r[k] - want[k]
            tol = DEPTH_TOL if "acc" in k else AB_MAE_RTOL * want[k]
            print(f"A/B {r['name']} {k}: {r[k]:.6f} (JAX CPU {want[k]}, diff {d:+.2e}, "
                  f"tolerance {tol:.2e})")
            if not (np.isfinite(r[k]) and abs(d) <= tol):
                failed.append(f"{r['name']} {k}")
        print(f"A/B {r['name']} (ks {r['ks']}): K2 launches {r['k2_launches']}, render "
              f"{mean_after_first(r['render_ms']):.3f} ms per scene (mean after the first)")
        if r["k2_launches"] != ref["val_len"]:
            failed.append(f"{r['name']}: {r['k2_launches']} K2 launches")
    if failed:
        raise RuntimeError(f"far-field A/B off the JAX reference: {failed}")
    return {"launches": launches,
            "arms": {r["name"]: {**{k: r[k] for k in (*eval_farfield_ab.COLUMNS,
                                                     "k2_launches", "ks")},
                                 "render_ms": mean_after_first(r["render_ms"])}
                     for r in rows}}


def profile_train_step(dfdp_net, path, bs, train_mode="dfdp", **sides):
    """A torch.profiler breakdown of one render + train step of the config
    at ``path`` (its widths, a fresh net), as train() runs it, after a
    warm-up step: the device's busy time and idle share per step."""
    from sdirt_tpu_torch.dfdp.datasets import SyntheticRGBD
    from sdirt_tpu_torch.dfdp.train import create_dfdp_state, dfdp_train_step

    with tempfile.TemporaryDirectory() as tmp:
        args = dfdp_net.load_config(cut_config(path, tmp, **sides)[0])
    lens, _ = dfdp_net.get_lens(args, device="cuda")
    ds = SyntheticRGBD(tuple(args["res"]), length=bs,
                       style=args.get("synthetic_style", "v1"))
    aif = np.stack([ds[i][0] for i in range(bs)])
    gt = np.stack([ds[i][1] for i in range(bs)])
    state = create_dfdp_state(dfdp_net.build_basenet(
        device="cuda", train=True, train_mode=train_mode,
        n_views=getattr(lens, "n_views", 1)), args["lr"], 10)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def step():
        stack, depth, aif_dev = dfdp_net._render_batch(lens, aif, gt, gen, train=True)
        dfdp_train_step(state, stack, depth, aif_dev if train_mode == "deblur" else None)

    wall = cuda_time_ms(step, 3, 1)
    rows, busy = device_profile(step, 3)
    print_profile(f"{os.path.basename(path)} render + train step", rows, busy, 3, wall)
    del state, lens
    torch.cuda.empty_cache()
    return {"step_ms": wall, "device_busy_ms": busy / 3 if rows else None,
            "device_idle_share": 1 - busy / 3 / wall if rows else None}


def train_cut(dfdp_net, fused_conv, path, tmp, bs, extra_argv=(), **sides):
    """--stage train through dfdp_net.main() on the config at ``path``, cut
    in length only (NEW_TRAIN_CUTS: 1 epoch of 4 steps, 2 validation
    items); returns (its result, K2 launches, peak GiB, the log's text)."""
    cfg_path, cfg = cut_config(path, tmp, **NEW_TRAIN_CUTS, synthetic_len=4 * bs,
                               ckpt_out=os.path.join(tmp, "best"),
                               train_state_dir=os.path.join(tmp, "state"), **sides)
    if (cfg["bs"], tuple(cfg["res"])) != (bs, (256, 384)):
        raise RuntimeError(f"{path} is not at 256x384, bs {bs}")
    out = os.path.join(tmp, "results")
    fused_conv.launches = 0
    k3_reset()
    torch.cuda.reset_peak_memory_stats()
    res = dfdp_net.main(["--stage", "train", "--config", cfg_path, "--device", "cuda",
                         "--out", out, *extra_argv])
    launches = fused_conv.launches
    k3_count(f"train {os.path.basename(path)}", K3_PER_RENDER["fused"] * launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(out, "train.log")) as f:
        log = f.read()
    print(f"training {path} at 256x384, bs {bs}, style {cfg['synthetic_style']}, ks "
          f"{cfg['ks']}; cut in length only: {NEW_TRAIN_CUTS}, {4 * bs} scenes")
    for i, (s, terms) in enumerate(zip(res["steps"], res["loss_terms"])):
        print(f"  step {i}: render {s['render_ms']:.3f} ms, train step "
              f"{s['train_step_ms']:.3f} ms, losses {terms}")
    if len(res["losses"]) != 4:
        raise RuntimeError(f"{path}: {len(res['losses'])} steps trained, not 4")
    return res, launches, peak, log


def deblur_phase(dfdp_net, fused_conv, smi):
    """Phase 16: --train-mode deblur: the sample stage on the copy of the
    128x192 deblur config that names the shipped deblur net (held against
    the JAX CPU run), training on the 256x384 deblur config, and three train
    steps against the JAX package's float64 losses."""
    from sdirt_tpu_torch.dfdp.train import create_dfdp_state, dfdp_train_step

    with open(os.path.join(REF_DIR, "stage_sample_deblur_jax_cpu.json")) as f:
        ref = json.load(f)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path, _ = cut_config(DEBLUR_SAMPLE_CONFIG, tmp,
                                 train={"dfdpnet_pretrained": DEBLUR_NET})
        fused_conv.launches = 0
        k3_reset()
        result = dfdp_net.main(["--stage", "sample", "--config", cfg_path, "--train-mode",
                                "deblur", "--device", "cuda", "--out",
                                os.path.join(tmp, "out")])
        out["sample_launches"] = fused_conv.launches
        k3_count("deblur_sample", K3_PER_RENDER["fused"] * out["sample_launches"])
    for tag, m in result["depth"].items():
        for k, v in ref["depth"][tag].items():
            d = m[k] - v
            print(f"deblur depth {tag} {k}: {m[k]:.6f} (JAX CPU {v:.6f}, diff {d:+.2e})")
            if not (np.isfinite(m[k]) and abs(d) <= DEPTH_TOL):
                raise RuntimeError(f"deblur depth {tag} {k} off the JAX reference")
    print(f"deblur sample stage: K2 launches {out['sample_launches']} (flat renders); "
          f"host seconds {result['seconds']}")

    with tempfile.TemporaryDirectory() as tmp:
        res, launches, peak, _ = train_cut(dfdp_net, fused_conv, DEBLUR_TRAIN_CONFIG, tmp,
                                           2, ["--train-mode", "deblur"])
    want = 4 + 2 * NEW_TRAIN_CUTS["synthetic_val_len"]
    terms = res["loss_terms"]
    print(f"K2 launches on deblur training: {launches} (4 steps + 2 validations x "
          f"{NEW_TRAIN_CUTS['synthetic_val_len']} = {want}); validation "
          f"{[{k: round(v, 4) for k, v in m.items()} for m in res['val']]}")
    if launches != want:
        raise RuntimeError("deblur training did not launch K2 once per step and item")
    if any(set(t) != {"depth_est", "depth_fix", "aif", "total"} for t in terms):
        raise RuntimeError(f"deblur training lost a loss term: {terms}")
    render_ms = mean_after_first([s["render_ms"] for s in res["steps"]])
    step_ms = mean_after_first([s["train_step_ms"] for s in res["steps"]])
    print(f"deblur training per step (mean after the first): render {render_ms:.3f} ms, "
          f"train step {step_ms:.3f} ms; max_memory_allocated {peak:.2f} GiB ({smi})")
    out.update(train_launches=launches, render_ms=render_ms, train_step_ms=step_ms,
               peak_gib=peak, losses=terms)

    with open(os.path.join(REF_DIR, "train_step_deblur_jax_cpu.json")) as f:
        sref = json.load(f)
    with np.load(os.path.join(ROOT, sref["stacks"])) as z:
        stacks, depths = z["stacks"], z["depths"]
    with np.load(os.path.join(ROOT, sref["aif"])) as z:
        aifs = z["aif"]
    state = create_dfdp_state(dfdp_net.build_basenet(
        os.path.join(ROOT, sref["weights"]), device="cuda", train=True,
        train_mode="deblur"), sref["lr"], sref["total_steps"])
    worst = 0.0
    for k in range(sref["steps"]):
        got = dfdp_train_step(state, torch.from_numpy(stacks[k].astype(np.float32) / 65535).cuda(),
                              torch.from_numpy(depths[k].astype(np.float32)).cuda(),
                              torch.from_numpy(aifs[k].astype(np.float32) / 255.0).cuda())
        for name, v in sref["losses"][k].items():
            gap = abs(float(got[name]) - v) / v
            worst = max(worst, gap)
            print(f"deblur train step {k} {name}: {float(got[name]):.6f} (JAX CPU float64 "
                  f"{v:.6f}, relative gap {gap:.2e})")
    print(f"deblur train steps on the stored stacks: worst relative gap {worst:.3e} "
          f"(tolerance {sref['stored_stacks_rtol']})")
    if not worst <= sref["stored_stacks_rtol"]:
        raise RuntimeError("deblur train steps off the JAX reference")
    out["reference_worst_rel_gap"] = worst
    del state
    torch.cuda.empty_cache()
    out["profile"] = profile_train_step(dfdp_net, DEBLUR_TRAIN_CONFIG, 2, "deblur")
    return out


def stack_phase(dfdp_net, fused_conv, smi):
    """Phase 17: --stage train on a 2-focus stack config (the second view the
    shipped F4_PSFNet_mlp@256 refocused to 5 m), and one ThinLens batch on
    the card against the CPU."""
    from sdirt_tpu_torch.dfdp.datasets import SyntheticRGBD
    from sdirt_tpu_torch.psfnet.thinlens import ThinLens

    import yaml

    with open(STACK_CONFIG) as f:
        stack = yaml.safe_load(f)["train"]["stack"]
    stack = [stack[0], {**stack[1], **STACK_VIEW2}]
    with tempfile.TemporaryDirectory() as tmp:
        res, launches, peak, log = train_cut(dfdp_net, fused_conv, STACK_CONFIG, tmp, 4,
                                             train={"stack": stack}, test={"stack": stack})
    net = res["state"].net
    cin = net.dfdp_net.Feature_0.BasicConv_0.Conv_0.weight.shape[1]
    want = 2 * (4 + 2 * NEW_TRAIN_CUTS["synthetic_val_len"])
    skipped = dfdp_net.MULTI_FOCUS_SKIP in log
    print(f"stack training: {net.n_views} views, feature tower input {cin} channels "
          f"(net input {6 * net.n_views}); K2 launches {launches} (2 views x (4 steps + "
          f"2 validations x {NEW_TRAIN_CUTS['synthetic_val_len']}) = {want}); real-capture "
          f"eval skipped with the JAX log line: {skipped}")
    if (net.n_views, cin) != (2, 6) or launches != want or not skipped:
        raise RuntimeError("the stack's training path is not what the config asks")
    render_ms = mean_after_first([s["render_ms"] for s in res["steps"]])
    step_ms = mean_after_first([s["train_step_ms"] for s in res["steps"]])
    print(f"stack training per step (mean after the first): render {render_ms:.3f} ms, "
          f"train step {step_ms:.3f} ms; max_memory_allocated {peak:.2f} GiB ({smi})")
    losses = res["loss_terms"]
    del net, res
    torch.cuda.empty_cache()
    profile = profile_train_step(dfdp_net, STACK_CONFIG, 4, train={"stack": stack},
                                 test={"stack": stack})

    ds = SyntheticRGBD((256, 384), length=2, seed=999, train=False, style="v2")
    aif = np.stack([ds[i][0] for i in range(2)])
    depth = -np.stack([ds[i][1] for i in range(2)]) * 1e3
    foc = np.array([-1000.0, -1000.0], np.float32)
    renders = {}
    for dev in ("cuda", "cpu"):
        thin = ThinLens(**THIN_LENS, sensor_res=(256, 384), device=dev)
        renders[dev] = thin.render(aif, depth, foc).cpu()
    thin = ThinLens(**THIN_LENS, sensor_res=(256, 384), device="cuda")
    thin_ms = cuda_time_ms(lambda: thin.render(aif, depth, foc), 3)
    diff = float((renders["cuda"] - renders["cpu"]).abs().max())
    print(f"ThinLens {THIN_LENS} render 2x3x256x384 on the card: {thin_ms:.3f} ms; "
          f"card vs CPU max |diff| {diff:.3e} (tolerance {THIN_TOL})")
    if not diff <= THIN_TOL:
        raise RuntimeError("the thin-lens render on the card disagrees with the CPU")
    return {"launches": launches, "render_ms": render_ms, "train_step_ms": step_ms,
            "peak_gib": peak, "losses": losses, "profile": profile,
            "thinlens_ms": thin_ms, "thinlens_card_vs_cpu": diff}


def analysis_check(fit, out, fitted):
    """The fit's lens analysis (phase 6) against the JAX CPU reference: the
    RMS radii and d_sensor within 5x the JAX spread over three keys, the
    per-cell max-normalised PSF map's mean |difference| from the JAX mean
    map within 5x the JAX keys' spread; every file read back; then
    time_compare_psf on the fitted surrogate."""
    from sdirt_tpu_torch.dfdp.datasets import read_png

    with open(os.path.join(REF_DIR, "analysis_jax_cpu.json")) as f:
        ref = json.load(f)["stats"]
    failed, result = [], {"seconds": {}, "rms": {}, "psf_map_mean_abs": {}}
    st = ref["d_sensor"]
    d = fit["d_sensor"] - st["mean"]
    print(f"analysis d_sensor {fit['d_sensor']!r}: JAX CPU mean {st['mean']!r}, diff "
          f"{d:+.3e}, tolerance {st['tolerance']:.3e}")
    if not abs(d) <= st["tolerance"]:
        failed.append("d_sensor")
    for depth, rms in fit["analysis"].items():
        st = ref[str(depth)]
        secs = fit["seconds"]["analysis"][depth]
        result["seconds"][str(depth)] = secs
        result["rms"][str(depth)] = rms
        print(f"analysis at {depth} mm: {secs:.3f} s")
        for k, v in zip(("rms_avg", "rms_on", "rms_off"), rms):
            d = v - st[k]["mean"]
            print(f"  {k}: {v * 1e3:.4f} um (JAX CPU mean {st[k]['mean'] * 1e3:.4f}, spread "
                  f"{st[k]['spread'] * 1e3:.4f}, diff {d * 1e3:+.4f}, tolerance "
                  f"{st[k]['tolerance'] * 1e3:.4f})")
            if not (np.isfinite(v) and abs(d) <= st[k]["tolerance"]):
                failed.append(f"{depth} {k}")
        tag = int(depth)
        setup = np.load(os.path.join(out, f"{tag}.npz"))
        png = read_png(os.path.join(out, f"{tag}_psf{-tag}mm_left.png"))
        psf_map = np.load(os.path.join(out, f"{tag}_psf{-tag}mm_left.npz"))["psf_map"]
        ref_map = read_png(os.path.join(REF_DIR, st["psf_map"]["png"])) / 255.0
        mad = float(np.abs(psf_map - ref_map).mean())
        result["psf_map_mean_abs"][str(depth)] = mad
        print(f"  files: {tag}.npz ({len(setup.files)} arrays), PSF map PNG "
              f"{png.shape} {png.dtype}; map mean |diff| from the JAX mean map {mad:.4f} "
              f"(JAX keys' spread {st['psf_map']['spread_mean_abs']:.4f}, tolerance "
              f"{st['psf_map']['tolerance_mean_abs']:.4f})")
        if png.shape != psf_map.shape or not mad <= st["psf_map"]["tolerance_mean_abs"]:
            failed.append(f"{depth} psf map")
    panels = sorted(p for p in os.listdir(out) if p.startswith("compare_") and p.endswith(".png"))
    shapes = {read_png(os.path.join(out, p)).shape for p in panels}
    print(f"compare_psf panels read back: {len(panels)} PNGs of shape {shapes}")
    if len(panels) != 6:
        failed.append("compare_psf panels")
    if failed:
        raise RuntimeError(f"the lens analysis is off the JAX reference: {failed}")
    t_rt, t_net = fitted.time_compare_psf(log_fn=lambda m: print(f"time_compare_psf: {m}"))
    result["time_compare_psf_s"] = {"ray_tracing": t_rt, "network": t_net}
    # the analysis's per-surface trace of one RMS bundle (31 x 31 x 2048 rays)
    bundle = fitted.sample_point_source(depth=-1000.0, R=100.0, M=31, spp=2048,
                                        generator=torch.Generator(device="cuda").manual_seed(0))
    ms = cuda_time_ms(lambda: fitted.trace(bundle), 5)
    print_profile("per-surface trace, 31 x 31 x 2048 rays", *device_profile(
        lambda: fitted.trace(bundle), 3), 3, ms)
    result["rms_bundle_trace_ms"] = ms
    return result


def fit_heads_phase(fit_psfnet, fused_trace, PSFNetLens, create_train_state,
                    make_train_step, smi):
    """The mlpconv and siren fits at the published width through
    fit_psfnet.main() (11 steps, one eval): finite losses, K1 launched; then
    each head's train step timed by CUDA events."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for model in ("mlpconv", "siren"):
        with tempfile.TemporaryDirectory() as tmp:
            fused_trace.launches = 0
            res = fit_psfnet.main(HEAD_FIT_ARGS + ["--model", model, "--result-dir", tmp])
            launches = fused_trace.launches
            saved = os.path.exists(os.path.join(tmp, f"psfnet_{model}.npz"))
        losses = np.array(res["losses"])
        print(f"fit {model}: {len(losses)} steps, losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
              f"evals {res['evals']}; K1 launches {launches}; host seconds {res['seconds']}")
        if not (np.isfinite(losses).all() and all(np.isfinite(e[1:]).all() for e in res["evals"])
                and launches > 0 and saved):
            raise RuntimeError(f"the {model} fit failed (losses finite, K1 launched, net saved)")
        lens = PSFNetLens("lenses/rf50mm/lens_web.json", model_name=model, kernel_size=KS,
                          sensor_res=(512, 768), device="cuda")
        lens.refocus(-1000.0 + lens.d_sensor)
        state = create_train_state(lens.net, 1e-4, 90000)
        step_fn = make_train_step(lens, bs=64, spp=20000, ks=KS)
        step_ms = cuda_time_ms(lambda: step_fn(state, gen), 10)
        print(f"fit {model}: train step {step_ms:.3f} ms (CUDA events, bs 64 x 20000 rays); {smi}")
        out[model] = {"k1_launches": launches, "step_ms": step_ms,
                      "loss_first": float(losses[0]), "loss_last": float(losses[-1])}
    return out


def baselines_phase(PSFNetLens):
    """The four baseline models on a 512 x 768 depth map at ks 21: the card
    against its CPU run of the same function on the same inputs and lens
    scalars, and ms per call."""
    from sdirt_tpu_torch.psfnet import baselines

    lens = PSFNetLens("lenses/rf50mm/lens_web.json", kernel_size=KS, sensor_res=(512, 768),
                      device="cuda")
    rng = np.random.default_rng(0)
    inp = np.concatenate([rng.uniform(-1, 1, (512, 768, 2)),
                          rng.uniform(0, 1, (512, 768, 1))], -1).astype(np.float32)
    x_cpu = torch.from_numpy(inp)
    x = x_cpu.cuda()
    out = {}
    for name in BASELINES:
        fn = getattr(baselines, name)
        got = fn(lens, x).cpu()
        diff = float((got - fn(lens, x_cpu)).abs().max())
        del got
        ms = cuda_time_ms(lambda: fn(lens, x), 5)
        print(f"baseline {name}: [512, 768, 2, {KS}, {KS}], card vs CPU max |diff| "
              f"{diff:.3e} (tolerance {BASELINE_TOL:g}); {ms:.3f} ms per call")
        if not diff <= BASELINE_TOL:
            raise RuntimeError(f"baseline {name} on the card disagrees with its CPU run")
        out[name] = {"max_abs_diff": diff, "ms": ms}
    return out


def coherent_phase(Lens):
    """python -m sdirt_tpu_torch.coherent_demo at its defaults with --image
    through its main(); then the coherent grid at the JAX CPU run's sensor
    distance held against sdirt_tpu_torch/reference/coherent_jax_cpu.json,
    and ms per coherent_psf_grid at M 512."""
    from sdirt_tpu_torch import coherent_demo
    from sdirt_tpu_torch.dfdp.datasets import read_png
    from sdirt_tpu_torch.dp.coherent import coherent_psf_grid

    with open(os.path.join(REF_DIR, "coherent_jax_cpu.json")) as f:
        ref = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = coherent_demo.main(["--device", "cuda", "--image", "--out", tmp])
        secs = time.perf_counter() - t0
        shapes = [read_png(os.path.join(tmp, f"psf_panel_{int(-d)}.png")).shape
                  for d in COHERENT_DEPTHS]
        image = read_png(os.path.join(tmp, "interference_image.png")).shape
    print(f"coherent demo: {secs:.3f} s; panels {shapes}, image {image}")
    if not all(np.isfinite(v["contrast"]).all() for v in res["depths"].values()):
        raise RuntimeError("the coherent demo's contrasts are not finite")
    lens = Lens("lenses/rf50mm/lens_web.json", sensor_res=(512, 768), device="cuda")
    lens.d_sensor = ref["d_sensor"]
    lens.post_computation()
    failed, out = [], {"demo_s": secs, "depths": {}}
    for depth in COHERENT_DEPTHS:
        coh, inc = coherent_psf_grid(lens, depth, grid=1, ks=ref["ks"], M=ref["M"], ps=ref["ps"])
        r = ref["depths"][str(depth)]
        row = {}
        for kind, psf in (("coherent", coh), ("incoherent", inc)):
            prof = coherent_demo.radial_profile(psf[0, 0].cpu().numpy())
            row[f"contrast_{kind}"] = coherent_demo.ring_contrast(prof)
            row[f"profile_{kind}"] = float(np.abs(prof - np.array(r[f"profile_{kind}"])).max())
        d_c = {k: abs(row[f"contrast_{k}"] - r[f"contrast_{k}"]) for k in ("coherent", "incoherent")}
        print(f"coherent {depth} mm: ring contrast coherent {row['contrast_coherent']:.4f} (JAX CPU "
              f"op by op {r['contrast_coherent']:.4f}, jitted "
              f"{ref['depths_jit'][str(depth)]['contrast_coherent']:.4f}), incoherent "
              f"{row['contrast_incoherent']:.4f} (JAX CPU {r['contrast_incoherent']:.4f}); radial "
              f"profile max |diff| coherent {row['profile_coherent']:.4f}, incoherent "
              f"{row['profile_incoherent']:.2e}")
        for k in ("coherent", "incoherent"):
            if not d_c[k] <= COHERENT_TOL[f"contrast_{k}"]:
                failed.append(f"{depth} contrast {k}")
            if not row[f"profile_{k}"] <= COHERENT_TOL[f"profile_{k}"]:
                failed.append(f"{depth} profile {k}")
        out["depths"][str(depth)] = row
    if failed:
        raise RuntimeError(f"coherent PSFs off the JAX reference: {failed}")
    grid = lambda: coherent_psf_grid(lens, -1100.0, grid=1, ks=ref["ks"], M=ref["M"],
                                     ps=ref["ps"])
    out["grid_ms"] = cuda_time_ms(grid, 5)
    print(f"coherent_psf_grid, one point, M {ref['M']} ({ref['M'] ** 2} rays), ks {ref['ks']}: "
          f"{out['grid_ms']:.3f} ms (CUDA events)")
    print_profile("coherent grid", *device_profile(grid, 3), 3, out["grid_ms"])
    return out


def lens_design_phase():
    """python -m sdirt_tpu_torch.demo_lens_design at its defaults (300
    steps) through its main(), on the JAX package's own draws, held against
    sdirt_tpu_torch/reference/lens_design_jax_cpu.npz."""
    from sdirt_tpu_torch import demo_lens_design

    path = os.path.join(REF_DIR, "lens_design_jax_cpu.npz")
    ref = np.load(path)
    res = demo_lens_design.main(["--device", "cuda", "--draws", path])
    failed, out = [], {"ms_per_step": res["ms_per_step"], "ok": res["ok"]}
    for k, tol in LENS_DESIGN_TOL.items():
        d = float(np.abs(res[k] - ref[k]).max())
        out[k] = [float(v) for v in res[k]]
        print(f"lens design {k}: {np.round(res[k], 4).tolist()} um (JAX CPU "
              f"{np.round(ref[k], 4).tolist()}), max |diff| {d:.4f} (tolerance {tol})")
        if not d <= tol:
            failed.append(k)
    print(f"lens design: {res['ms_per_step']:.3f} ms per optimisation step (host clock, "
          f"300 steps); RECOVERY {'OK' if res['ok'] else 'WEAK'} (JAX CPU: "
          f"{'OK' if int(ref['ok']) else 'WEAK'})")
    # a step's trace, forward and backward (the three wavelengths in one)
    from sdirt_tpu_torch.core.rays import Rays
    from sdirt_tpu_torch.optics.lens import Lens
    from sdirt_tpu_torch.optics.optimize import apply_params, optimizable_params

    lens = Lens("lenses/rf50mm/lens_web.json", sensor_res=(512, 768), device="cuda")
    eta = torch.stack([lens.eta_arrays(w, True)[0] for w in demo_lens_design.WVLNS],
                      1)[..., None, None]
    skip = lens.eta_arrays(demo_lens_design.WVLNS[0], True)[1]
    pts = np.array([[0.0, 0.0, -20000.0]], np.float32).repeat(3, 0)
    per_wvln = [lens.sample_from_points(pts, spp=256, xy=ref[f"pupil_{i}"]) for i in range(3)]
    rays = Rays(*(torch.stack([getattr(r, a) for r in per_wvln]) for a in ("o", "d", "ra")))
    params = optimizable_params(lens.stack)

    def trace_step():
        out_r = demo_lens_design.trace_rgb(rays, apply_params(lens.stack, params), eta,
                                           skip, lens.d_sensor)
        out_r.o[..., :2].square().sum().backward()

    ms = cuda_time_ms(trace_step, 5)
    print_profile("lens-design step's trace (3 wavelengths), forward + backward",
                  *device_profile(trace_step, 3), 3, ms)
    out["trace_step_ms"] = ms
    if not (res["ok"] and int(ref["ok"])):
        failed.append("recovery")
    if failed:
        raise RuntimeError(f"the lens-design demo is off the JAX reference: {failed}")
    return out


def step_view(mix, n):
    """A training mix cut to ``n`` items for a short run: item k is item
    k // P of the mix's part k % P (P parts), by its index in the mix.
    Counts the parts it served (``served``)."""
    from sdirt_tpu_torch.dfdp.datasets import Subset

    class StepView(Subset):
        def __getitem__(self, i, rng=None):
            with self.lock:             # the loader's workers are threads
                self.served[self.kinds[i]] += 1
            return super().__getitem__(i, rng)

    starts = np.cumsum([0] + [len(d) for d in mix.datasets])
    parts = len(mix.datasets)
    view = StepView(mix, [int(starts[k % parts]) + k // parts for k in range(n)])
    view.kinds = [type(mix.datasets[k % parts]).__name__ for k in range(n)]
    view.served, view.lock = collections.Counter(), threading.Lock()
    return view


def write_ft3d_tree(root, n, seed):
    """n FlyingThings3D scenes at 960x540 in the published layout: AiF.png
    (the port's PNG writer) and disp.exr = depth x 20 (its EXR writer, ZIP),
    from seeded SyntheticRGBD v5 scenes."""
    from sdirt_tpu_torch.dfdp.datasets import SyntheticRGBD
    from sdirt_tpu_torch.io.exr import write_exr
    from sdirt_tpu_torch.utils.png import write_png

    ds = SyntheticRGBD(FT3D_RES, length=n, seed=seed, train=False, style="v5")
    for i in range(n):
        aif, depth = ds[i]
        scene = os.path.join(root, f"{i:04d}")
        os.makedirs(scene)
        write_png(os.path.join(scene, "AiF.png"), aif.transpose(1, 2, 0))
        write_exr(os.path.join(scene, "disp.exr"), depth[0] * 20.0, compression="zip")
    return root


def real_data_phase(dfdp_net, fused_conv, smi):
    """Phase 22: --stage train on the published configuration
    (configs/dfdp_by_sdirt_rf50mm.yml) at its width, its dataset roots
    pointed at the committed NYU tree and written FlyingThings3D trees."""
    from sdirt_tpu_torch.dfdp.datasets import NYUData, read_png
    from sdirt_tpu_torch.io.exr import read_exr
    from sdirt_tpu_torch.io.jpeg import read_jpeg

    out = {}
    jpg = sorted(NYUData(NYU_TREE).imgs)[0]
    read_jpeg(jpg)
    t0 = time.perf_counter()
    for _ in range(3):
        read_jpeg(jpg)
    out["jpeg_decode_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        roots = {k: write_ft3d_tree(os.path.join(tmp, k), n, 11 + i)
                 for i, (k, n) in enumerate(FT3D_SCENES.items())}
        exr = os.path.join(roots["FlyingThings3D_train"], "0000", "disp.exr")
        read_exr(exr)
        t0 = time.perf_counter()
        for _ in range(3):
            read_exr(exr)
        out["exr_read_ms"] = (time.perf_counter() - t0) / 3 * 1e3
        print(f"host decode (numpy): one 640x480 JPEG (q95, 4:2:0) "
              f"{out['jpeg_decode_ms']:.1f} ms, one 960x540 float EXR (ZIP) "
              f"{out['exr_read_ms']:.1f} ms")
        real = {f"real_{k}_test": f"./real_sample_set/{k}" for k in ("flat", "casual")}
        # the per-epoch real box evaluation, cut to its first scene: a box
        # scene's 4000x6000 depth PNG takes seconds to decode on the host
        box = os.path.join(tmp, "box")
        os.makedirs(box)
        first_box = sorted(os.listdir("real_sample_set/box"))[0]
        os.symlink(os.path.join(ROOT, "real_sample_set", "box", first_box),
                   os.path.join(box, first_box))
        real["real_box_test"] = box
        cfg_path, cfg = cut_config(REAL_CONFIG, tmp, **REAL_CUTS, **roots, **real,
                                   NYUdata_train=NYU_TREE)
        full = dfdp_net.load_config(REAL_CONFIG)
        print(f"published training: {REAL_CONFIG} at {cfg['res'][0]}x{cfg['res'][1]}, bs "
              f"{cfg['bs']}, ks {cfg['ks']}, lr {cfg['lr']}, surrogate "
              f"{cfg['train']['psfnet_path']}, warm start "
              f"{cfg['train']['dfdpnet_pretrained']}; datasets NYUdata (the committed "
              f"2 x 4 tree) + FlyingThings3D ({FT3D_SCENES}, {FT3D_RES[1]}x{FT3D_RES[0]}, "
              f"written here); cut in length only: {REAL_CUTS} (the config's: "
              f"{ {k: full[k] for k in REAL_CUTS} }), each training set cut to "
              f"{REAL_STEPS} steps by step_view, the per-epoch real box set to its "
              f"first scene ({first_box})")
        views = []
        get_dataset, train_step = dfdp_net.get_dataset, dfdp_net.dfdp_train_step
        step_mem = []

        def cut_dataset(args):
            first, second, val = get_dataset(args)
            views[:] = [step_view(first, REAL_STEPS * args["bs"]),
                        step_view(second, REAL_STEPS * args["bs"])]
            return views[0], views[1], val

        def measured_step(*a, **k):
            losses = train_step(*a, **k)
            step_mem.append(torch.cuda.max_memory_allocated() / 2**30)
            return losses

        dfdp_net.get_dataset, dfdp_net.dfdp_train_step = cut_dataset, measured_step
        fused_conv.launches = 0
        k3_reset()
        torch.cuda.reset_peak_memory_stats()
        results = os.path.join(tmp, "results")
        t0 = time.perf_counter()
        try:
            res = dfdp_net.main(["--stage", "train", "--config", cfg_path, "--device",
                                 "cuda", "--out", results, "--save-images"])
        finally:
            dfdp_net.get_dataset, dfdp_net.dfdp_train_step = get_dataset, train_step
        out["main_s"] = time.perf_counter() - t0
        out["k2_launches"] = fused_conv.launches
        k3_count("published_train", K3_PER_RENDER["fused"] * out["k2_launches"])
        n_val = FT3D_SCENES["FlyingThings3D_test"]
        epochs = REAL_CUTS["epochs"]
        want = epochs * REAL_STEPS + (epochs + 1) * n_val
        losses = np.array(res["losses"])
        print(f"K2 launches on the published training: {out['k2_launches']} ({epochs} "
              f"epochs x {REAL_STEPS} steps + {epochs + 1} validations x {n_val} items "
              f"= {want})")
        if len(losses) != epochs * REAL_STEPS or out["k2_launches"] != want:
            raise RuntimeError("the published training did not launch K2 once per step "
                               "and validation item")
        if not np.isfinite(losses).all():
            raise RuntimeError(f"non-finite training loss: {losses}")
        first, second = (dict(v.served) for v in views)
        print(f"items served: first-half mix (epochs 0-{epochs // 2}) {first}; "
              f"second half (epoch {epochs - 1}) {second}")
        n_items = REAL_STEPS * cfg["bs"]
        if (first.get("FlyingThings3D", 0) == 0 or sum(first.values()) != 2 * n_items
                or set(second) != {"NYUData"} or sum(second.values()) != n_items):
            raise RuntimeError("the FlyingThings3D mix was not used in epochs 0-1 and "
                               "NYU alone in epoch 2")
        for i, (s_, mem) in enumerate(zip(res["steps"], step_mem)):
            print(f"  step {i}: data wait {s_['data_wait_s'] * 1e3:.1f} ms, render "
                  f"{s_['render_ms']:.3f} ms, train step {s_['train_step_ms']:.3f} ms, "
                  f"max_memory_allocated {mem:.2f} GiB, loss {losses[i]:.6f}")
        steps = res["steps"]
        out.update(losses=losses.tolist(), max_memory_allocated_gib=max(step_mem),
                   data_wait_ms=mean_after_first([s_["data_wait_s"] * 1e3 for s_ in steps]),
                   render_ms=mean_after_first([s_["render_ms"] for s_ in steps]),
                   train_step_ms=mean_after_first([s_["train_step_ms"] for s_ in steps]),
                   epoch_seconds=res["epoch_seconds"], items_served=[first, second])
        print(f"published training per step (mean after the first): data wait "
              f"{out['data_wait_ms']:.1f} ms, render {out['render_ms']:.3f} ms, train "
              f"step {out['train_step_ms']:.3f} ms; epochs {np.round(res['epoch_seconds'], 3).tolist()} "
              f"s; validation acc1 {[round(v['acc1'], 4) for v in res['val']]}; main() "
              f"{out['main_s']:.1f} s ({smi})")
        saved = sorted(os.listdir(os.path.join(results, "results")))
        tests = sorted(os.listdir(os.path.join(results, "tests")))
        want_files = [f"fs_{i}_{n}.png" for i in range(n_val) for n in (
            "rgb_gt_aif", "rgb_rt_l", "rgb_rt_r", "depth_gt", "depth_est")]
        missing = [f for f in want_files if f not in saved]
        missing += [f for f in ("box_0_rgb_gt_l.png", "box_0_depth_est.png") if f not in tests]
        jet = [read_png(os.path.join(results, "results", f"fs_0_{n}.png")).shape
               for n in ("depth_gt", "depth_est")]
        print(f"--save-images: {len(saved)} files under results/, {len(tests)} under "
              f"tests/; JET depth maps decode to {jet}")
        if missing or jet != [(*cfg["res"], 3)] * 2:
            raise RuntimeError(f"--save-images files missing or misshapen: {missing} {jet}")
    return out


def k1_vs_plain_probe(dp_disparity_probe, fused_trace):
    """K1 against its plain version at dp_disparity_probe --traced's
    shape: its lens refocused to 1 m, the point and its mirror at each of
    its depths, 200 000 main and GEO_SPP chief rays per point, the same
    pupil samples through both. Returns the PSFs' L1 (mean, max)."""
    from sdirt_tpu_torch.core.constants import GEO_SPP
    from sdirt_tpu_torch.dp.psf import dp_psf_fused, lens_scalars
    from sdirt_tpu_torch.optics.sampling import sample_disk
    from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens

    lens = PSFNetLens("lenses/rf50mm/lens_web.json", kernel_size=KS, sensor_res=(512, 768),
                      device="cuda")
    lens.refocus(-1000.0 + lens.d_sensor)
    plan, sc = fused_trace.make_fused_plan(lens), lens_scalars(lens)
    gen = torch.Generator(device="cuda").manual_seed(7)
    xy_main = sample_disk(gen, (PROBE_SPP,), sc["pupilr"], "cuda")
    xy_chief = sample_disk(gen, (GEO_SPP,), sc["pupilr"] * 0.25, "cuda")
    l1 = []
    with torch.no_grad():
        for d_m in dp_disparity_probe.DEPTHS:
            depth_mm = -d_m * 1e3 + lens.d_sensor
            pts = torch.tensor([[0.0, 0.0, depth_mm], [-0.0, 0.0, depth_mm]], device="cuda")
            psfs = [dp_psf_fused(pts, None, sc, plan, spp=PROBE_SPP, ks=KS,
                                 pupil_main=xy_main, pupil_chief=xy_chief, trace=trace)
                    for trace in (None, fused_trace.fused_trace_sensor_ref)]
            l1 += [(a - b).abs().mean((-1, -2)) for a, b in zip(*psfs)]
    l1 = torch.cat(l1)
    l1_mean, l1_max = float(l1.mean()), float(l1.max())
    print(f"K1 vs plain at the traced probe's shape ({len(dp_disparity_probe.DEPTHS)} "
          f"depths x 2 points x {PROBE_SPP} rays, focus 1 m), PSFs via dp_psf_fused: "
          f"L1 mean {l1_mean:.3e}, max {l1_max:.3e} (tolerances {PSF_L1_MEAN_TOL}, "
          f"{PSF_L1_MAX_TOL})")
    if not (l1_mean <= PSF_L1_MEAN_TOL and l1_max <= PSF_L1_MAX_TOL):
        raise RuntimeError("K1's PSFs disagree with the plain version's at the probe's shape")
    return {"l1_mean": l1_mean, "l1_max": l1_max}


def depth_tools_phase(fused_conv, fused_trace):
    """Phase 23: the depth-side tools through their main(), held against
    sdirt_tpu_torch/reference/depth_tools_jax_cpu.json."""
    from sdirt_tpu_torch import dp_disparity_probe, eval_depth_ckpt, finetune_real_loo

    with open(os.path.join(REF_DIR, "depth_tools_jax_cpu.json")) as f:
        ref = json.load(f)
    out, failed = {"seconds": {}}, []
    t0 = time.perf_counter()
    fused_conv.launches = 0
    k3_reset()
    res = eval_depth_ckpt.main(["--ckpt", "ckpt/rf50mm/Sdirt_best_acc1", "--val-len", "2",
                                "--device", "cuda"])
    out["seconds"]["eval_depth_ckpt"] = time.perf_counter() - t0
    out["eval_k2_launches"] = fused_conv.launches
    k3_count("eval_depth_ckpt", K3_PER_RENDER["fused"] * out["eval_k2_launches"])
    rows = {**res["synthetic"], **{f"real {k}": v for k, v in res["real"].items()}}
    tol = ref["eval_depth_ckpt"]["tolerance"]
    for k, want in ref["eval_depth_ckpt"]["rows"].items():
        d = {m: rows[k][m] - want[m] for m in ("acc1", "mae")}
        print(f"eval_depth_ckpt [{k}]: acc1 {rows[k]['acc1']:.4f} mae {rows[k]['mae']:.4f} "
              f"(JAX CPU {want['acc1']:.4f} / {want['mae']:.3f}; diff {d['acc1']:+.4f} / "
              f"{d['mae']:+.4f}, tolerance {tol})")
        if not all(abs(v) <= tol for v in d.values()):
            failed.append(f"eval_depth_ckpt {k}")
    n_synth = len(eval_depth_ckpt.STYLES) * 2
    print(f"K2 launches in eval_depth_ckpt: {out['eval_k2_launches']} (one per synthetic "
          f"render: {n_synth})")
    if out["eval_k2_launches"] != n_synth:
        failed.append("eval_depth_ckpt K2 launches")
    out["eval_depth_ckpt"] = rows

    t0 = time.perf_counter()
    rows = dp_disparity_probe.main(["--device", "cuda"])
    out["seconds"]["probe"] = time.perf_counter() - t0
    for r, want in zip(rows, ref["probe"]["rows"]):
        d = (r["disparity_px"] - want["disparity_px"], r["sigma_px"] - want["sigma_px"])
        if not max(abs(v) for v in d) <= PROBE_TOL_PX:
            failed.append(f"probe {r['depth_m']} m")
    worst = max(max(abs(r["disparity_px"] - w["disparity_px"]),
                    abs(r["sigma_px"] - w["sigma_px"]))
                for r, w in zip(rows, ref["probe"]["rows"]))
    print(f"dp_disparity_probe (surrogate): worst |diff| from the JAX CPU run {worst:.2e} px "
          f"(tolerance {PROBE_TOL_PX})")
    out["probe"] = rows

    out["probe_k1_vs_plain"] = k1_vs_plain_probe(dp_disparity_probe, fused_trace)
    t0 = time.perf_counter()
    fused_trace.launches = 0
    rows = dp_disparity_probe.main(["--device", "cuda", "--traced"])
    out["seconds"]["probe_traced"] = time.perf_counter() - t0
    out["probe_k1_launches"] = fused_trace.launches
    tr = ref["probe_traced"]
    # sigma is held by the disparity's rule: 5x the largest difference of a
    # depth's sigma between the JAX run's two key pairs
    sigma_tol = 5 * max(abs(a["sigma_px"] - b["sigma_px"])
                        for a, b in zip(tr["rows_keys01"], tr["rows_keys23"]))
    for r, a, b in zip(rows, tr["rows_keys01"], tr["rows_keys23"]):
        d = r["disparity_px"] - (a["disparity_px"] + b["disparity_px"]) / 2
        ds = r["sigma_px"] - (a["sigma_px"] + b["sigma_px"]) / 2
        print(f"  traced {r['depth_m']:.2f} m: disparity {r['disparity_px']:+.4f} px, sigma "
              f"{r['sigma_px']:.4f} px (JAX CPU {a['disparity_px']:+.4f} / "
              f"{b['disparity_px']:+.4f}, sigma {a['sigma_px']:.4f} / {b['sigma_px']:.4f}; "
              f"diff from their mean {d:+.4f} / {ds:+.4f}, tolerances "
              f"{tr['tolerance_px']:.4f} / {sigma_tol:.4f})")
        if not (abs(d) <= tr["tolerance_px"] and abs(ds) <= sigma_tol):
            failed.append(f"probe traced {r['depth_m']} m")
    want_k1 = 2 * len(rows)
    print(f"K1 launches in dp_disparity_probe --traced: {out['probe_k1_launches']} "
          f"(chief + main bundle per depth: {want_k1})")
    if out["probe_k1_launches"] != want_k1:
        failed.append("probe K1 launches")
    out["probe_traced"] = rows

    t0 = time.perf_counter()
    res = finetune_real_loo.main(["--ckpt", "ckpt/rf50mm/Sdirt_best_acc1", "--steps", "2",
                                  "--sets", "box", "--device", "cuda"])
    out["seconds"]["finetune_real_loo"] = time.perf_counter() - t0
    losses = np.array(res["fold_losses"])
    print(f"finetune_real_loo --steps 2 --sets box: {len(losses)} folds, losses "
          f"{losses.round(6).tolist()}; LOO {res['summary']}")
    if not np.isfinite(losses).all():
        failed.append("finetune losses")
    for fold in ref["finetune_real_loo"]["folds"]:
        i = fold["scene"]
        got_zs, got_ho = res["zero_shot"][i], res["held_out"][i]
        d = (got_zs[0] - fold["zero_shot_acc1"], got_ho[0] - fold["acc1"],
             got_ho[1] - fold["mae"])
        print(f"  box/{i}: zero-shot acc1 {got_zs[0]:.4f} (JAX CPU "
              f"{fold['zero_shot_acc1']:.4f}, diff {d[0]:+.4f}); held-out acc1 "
              f"{got_ho[0]:.4f} mae {got_ho[1]:.4f} (JAX CPU {fold['acc1']:.4f} / "
              f"{fold['mae']:.3f}, diff {d[1]:+.4f} / {d[2]:+.4f}; tolerance {DEPTH_TOL})")
        if not max(abs(v) for v in d) <= DEPTH_TOL:
            failed.append(f"finetune box/{i}")
    out["finetune"] = {"fold_losses": losses.tolist(), "summary": res["summary"]}
    print("depth tools, seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                               out["seconds"].items()))
    if failed:
        raise RuntimeError(f"the depth-side tools are off the JAX reference: {failed}")
    return out


DISTILL_ARGS = ["--lens", "lenses/rf50mm/lens_web.json", "--teacher", "mlp",
                "--teacher-ckpt", "ckpt/rf50mm/F4_PSFNet_mlp", "--student", BASIS_NET,
                "--warm", "ckpt/rf50mm/F4_PSFNet_mlp@256", "--bs", "8192", "--lr", "5e-5",
                "--ks", "21", "--iters", "200", "--eval-every", "100", "--device", "cuda"]
# the card's f32 steps against the JAX package's float64 ones: the CPU port in
# float64 is within 1e-6 (tests/test_torch_distill.py); f32 and cuBLAS's
# summation order leave ~1e-6, so 1e-3 holds with room for TF32 slipping in
DISTILL_RTOL = 1e-3
GATE_STUDENTS = {
    "mlp": ["--student-ckpt", "ckpt/rf35mm/F4_PSFNet_mlp@256"],
    "mlpb": ["--student", BASIS_NET, "--student-ckpt", "ckpt/rf35mm/F4_PSFNet_mlpb@256x48",
             "--variants", "basis", "scan", "scan_f32"]}
# two ranks on the one card over gloo: the fit step at its published width,
# the DfDP step at the training path's (512x768, bs 4, the shipped net)
PAR_FIT = {"lens": "lenses/rf50mm/lens_web.json", "ks": KS, "model": "mlp", "bs": 64,
           "spp": 20000, "lr": 1.0, "steps": 1, "n_data": 1, "seed": 5}
PAR_FIT_RTOL = 1e-6
PAR_DFDP_RTOL = 1e-4
MESH_FIT_ARGS = ["--device", "cuda", "--lens", "lenses/rf50mm/lens_web.json", "--model",
                 "mlp", "--ks", "21", "--res", "512", "768", "--bs", "64", "--spp", "20000",
                 "--iters", "4", "--evaluate-every", "1000", "--skip-analysis",
                 "--mesh", "1", "1"]


def distill_phase(fused_trace, smi):
    """Phase 24: the basis-student distillation and the teacher probe, held
    against sdirt_tpu_torch/reference/distill_jax_cpu.json."""
    from sdirt_tpu_torch import dfdp_net
    from sdirt_tpu_torch import distill_basis_student as distill
    from sdirt_tpu_torch import probe_teacher_l1
    from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens
    from sdirt_tpu_torch.psfnet.train import create_train_state
    from sdirt_tpu_torch.utils.weights import flax_to_torch

    with open(os.path.join(REF_DIR, "distill_jax_cpu.json")) as f:
        ref = json.load(f)
    with np.load(os.path.join(REF_DIR, "distill_queries.npz")) as z:
        queries = torch.from_numpy(z["inp"]).cuda()
        init = {k[len("init/"):]: z[k] for k in z.files if k.startswith("init/")}
    out, failed = {}, []

    def lens(model, weights):
        return PSFNetLens("lenses/rf50mm/lens_web.json", model_name=model, kernel_size=KS,
                          sensor_res=(512, 768), device="cuda").load_net(weights)

    teacher = lens("mlp", "sdirt_tpu_torch/weights/rf50mm/F4_PSFNet_mlp.npz")
    student = lens(BASIS_NET, "sdirt_tpu_torch/weights/rf50mm/F4_PSFNet_mlp@256.npz")
    student.net.load_state_dict({**student.net.state_dict(),
                                 **{k: v.cuda() for k, v in flax_to_torch(init).items()}})
    teacher.net.eval()
    state = create_train_state(student.net, ref["lr"], ref["iters"])
    step = distill.make_distill_step(teacher.net, state, KS)
    losses = [float(step(q)) for q in queries]
    rel = [abs(a - b) / b for a, b in zip(losses, ref["losses"])]
    print(f"distill steps on the JAX run's queries: losses {losses} (JAX float64 "
          f"{ref['losses']}; max relative diff {max(rel):.2e}, tolerance {DISTILL_RTOL})")
    if not max(rel) <= DISTILL_RTOL:
        failed.append("distill steps")
    out["first_steps_rel"] = max(rel)
    out["step_ms"] = cuda_time_ms(lambda: step(queries[0]), 50)
    rows, busy = device_profile(lambda: step(queries[0]), 20)
    print_profile("distill step (bs 8192: the w512 teacher's forward, the student's "
                  "step)", rows, busy, 20, out["step_ms"])
    out["step_idle"] = 1 - busy / 20 / out["step_ms"] if rows else None
    del teacher, student, state, step

    with tempfile.TemporaryDirectory() as tmp:
        fused_trace.launches = 0
        res = distill.main(DISTILL_ARGS + ["--out", tmp])
        out["k1_launches"] = fused_trace.launches
        losses = np.array(res["losses"])
        out["eval_ms"] = res["seconds"]["evals"] / len(res["evals"]) * 1e3
        out["loop_step_ms"] = res["seconds"]["steps"] / len(losses) * 1e3
        print(f"distill_basis_student.main (rf50mm, mlp -> {BASIS_NET} warm from "
              f"mlp@256, bs 8192, lr 5e-5, ks 21; cut in length only to 200 of "
              f"200 000 steps, evals every 100): losses {losses[0]:.4e} -> "
              f"{losses[-1]:.4e} (first 20 mean {losses[:20].mean():.4e}, last 20 "
              f"{losses[-20:].mean():.4e}); evals {res['evals']}; K1 launches "
              f"{out['k1_launches']} (16 per eval); host ms per step in the loop "
              f"{out['loop_step_ms']:.3f}, per eval {out['eval_ms']:.3f}")
        if not (np.isfinite(losses).all() and losses[-20:].mean() < losses[:20].mean()):
            failed.append("distill loss")
        if out["k1_launches"] != 16 * len(res["evals"]):
            failed.append("distill K1 launches")
        os.remove(os.path.join(tmp, "state", "step_200.pt"))
        again = distill.main(DISTILL_ARGS + ["--out", tmp, "--resume"])
        gap = float(np.max(np.abs(np.array(again["losses"]) - losses[100:])
                           / losses[100:]))
        print(f"--resume from step {again['start']}: {len(again['losses'])} steps, "
              f"largest relative diff from the unbroken run's losses {gap:.2e}")
        if again["start"] != 100 or len(again["losses"]) != 100 or not gap <= 1e-5:
            failed.append("distill resume")
        saved = lens(BASIS_NET, res["student"])
    args = dfdp_net.load_config("configs/dfdp_by_sdirt_rf50mm.yml")
    _, f20, depth = dfdp_net.get_flat_sample_set(args)[0]
    dof = saved.render(f20[None, :3], -depth[None] * 1e3, None, "basis")
    print(f"the distilled student through 'basis': {tuple(dof.shape)}, range "
          f"[{float(dof.min()):.4f}, {float(dof.max()):.4f}]")
    if dof.shape != (1, 6, 512, 768) or not bool(torch.isfinite(dof).all()):
        failed.append("distilled student render")
    del saved, dof

    fused_trace.launches = 0
    probe = probe_teacher_l1.main(["--lens", "lenses/rf50mm/lens_web.json", "--model",
                                   BASIS_NET, "--ckpt", "ckpt/rf50mm/F4_PSFNet_mlpb@256x48",
                                   "--device", "cuda"])
    out["probe_k1_launches"] = fused_trace.launches
    for k in ("l1", "l2"):
        st = ref["eval_stats"][k]
        d = probe[k] - st["mean"]
        print(f"probe_teacher_l1 {BASIS_NET} (rf50mm) {k}: {probe[k]!r} (JAX CPU mean "
              f"{st['mean']!r}, spread {st['spread']:.3e}, diff {d:+.3e}, tolerance "
              f"{st['tolerance']:.3e})")
        if not (np.isfinite(probe[k]) and abs(d) <= st["tolerance"]):
            failed.append(f"probe {k}")
    if out["probe_k1_launches"] != 16:
        failed.append("probe K1 launches")
    out["probe"] = probe
    print(f"distill: {out['step_ms']:.3f} ms per step (CUDA events), "
          f"{out['eval_ms']:.3f} ms per eval (host clock); {smi}")
    if failed:
        raise RuntimeError(f"the distillation is off the JAX reference: {failed}")
    return out


def student_gate_phase(fused_conv, smi):
    """Phase 25: gate_rf35_student.main() at the JAX script's defaults and on
    the promoted basis student, held against
    sdirt_tpu_torch/reference/student_gate_jax_cpu.json (512x768)."""
    from sdirt_tpu_torch import gate_rf35_student

    with open(os.path.join(REF_DIR, "student_gate_jax_cpu.json")) as f:
        ref = json.load(f)["512x768"]
    out, failed = {}, []
    for run, argv in GATE_STUDENTS.items():
        want = ref["runs"][run]
        fused_conv.launches = 0
        k3_reset()
        res = gate_rf35_student.main(argv + ["--device", "cuda"])
        launches = fused_conv.launches
        # one render per view and scene, on each row and the calibration's
        # w256 fused_int8 renders
        k3_count(f"student_gate {run}",
                 2 * 2 * (sum(K3_PER_RENDER.get(v, 0) for v in res["rows"])
                          + (K3_PER_RENDER["fused_int8"] if res["calibration"] else 0)))
        cal = (res["calibration"][0] - ref["calibration"]["psnr_l"],
               res["calibration"][1] - ref["calibration"]["psnr_r"])
        print(f"student gate ({run}): calibration {res['calibration']} (JAX CPU "
              f"{ref['calibration']}; diff {cal[0]:+.4f} / {cal[1]:+.4f} dB, tolerance "
              f"{PSNR_TOL_DB})")
        if not max(abs(v) for v in cal) <= PSNR_TOL_DB:
            failed.append(f"{run} calibration")
        n_k2 = 0
        for v, row in res["rows"].items():
            w = want["rows"][v]
            d = (row["agree_l"] - w["agree_l"], row["agree_r"] - w["agree_r"])
            ok = max(abs(x) for x in d) <= PSNR_TOL_DB
            want_k2 = 2 * 2 if v.startswith("fused") else 0   # per view and scene
            print(f"  {v}: agree {row['agree_l']:.4f} / {row['agree_r']:.4f} dB (JAX CPU "
                  f"{w['agree_l']:.4f} / {w['agree_r']:.4f}; diff {d[0]:+.4f} / "
                  f"{d[1]:+.4f}, tolerance {PSNR_TOL_DB}); {row['verdict']} (JAX {w['verdict']}); "
                  f"K2 launches {row['k2_launches']} (want {want_k2}); "
                  f"{row['render_ms']:.1f} ms per render (host clock)")
            if not ok:
                failed.append(f"{run} {v} agreement")
            if row["verdict"] != w["verdict"]:
                failed.append(f"{run} {v} verdict")
            if row["k2_launches"] != want_k2:
                failed.append(f"{run} {v} K2 launches")
            n_k2 += row["k2_launches"]
        # the calibration's w256 fused_int8 renders launch K2 as well
        cal_k2 = 2 * 2 if res["calibration"] is not None else 0
        print(f"  K2 launches in the run: {launches} (fused rows {n_k2} + the "
              f"calibration's fused_int8 {cal_k2})")
        if launches != n_k2 + cal_k2:
            failed.append(f"{run}: K2 launched outside the fused rows")
        out[run] = {"calibration": res["calibration"], "rows": res["rows"],
                    "k2_launches": launches}
    if failed:
        raise RuntimeError(f"the student gate is off the JAX reference: {failed}")
    return out


class _LogLines(list):
    """A logging handler's records, as text."""

    def __enter__(self):
        import logging

        self.handler = logging.Handler(logging.INFO)
        self.handler.emit = lambda r: self.append(r.getMessage())
        root = logging.getLogger()
        root.addHandler(self.handler)
        self.level = root.level
        root.setLevel(logging.INFO)
        return self

    def __exit__(self, *exc):
        import logging

        logging.getLogger().removeHandler(self.handler)
        logging.getLogger().setLevel(self.level)


def multi_gpu_phase(dfdp_net, fit_psfnet, fused_conv, fused_trace, smi):
    """Phase 26: --mesh 1 1 and --data-parallel through their main() on one
    card, then the sharded steps on 2 gloo ranks of the one card held to
    the one-rank step on the same samples."""
    from sdirt_tpu_torch.dfdp.datasets import SyntheticRGBD
    from sdirt_tpu_torch.parallel import launch
    from sdirt_tpu_torch.parallel import equivalence as eq

    out, failed = {}, []
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with _LogLines() as log:
            fit = fit_psfnet.main(MESH_FIT_ARGS + ["--result-dir", tmp])
        out["mesh_seconds"] = time.perf_counter() - t0
        out["mesh_k1_launches"] = fit["k1_launches"]
        print(f"fit_psfnet --mesh 1 1 (NCCL, one rank, the published width, 5 steps): "
              f"losses {np.round(fit['losses'], 6).tolist()}, K1 launches per rank "
              f"{fit['k1_launches']}, {out['mesh_seconds']:.1f} s with the rank's start; "
              f"log: {[m for m in log if 'mesh' in m]}")
        if not (np.isfinite(fit["losses"]).all() and len(fit["losses"]) == 5
                and fit["k1_launches"] == [10]
                and "multi-chip fit over mesh {'data': 1, 'rays': 1}" in log):
            failed.append("--mesh 1 1")

        # cut in length only: one step, one validation item, and the
        # per-epoch real box evaluation cut to one scene (as phase 22's)
        box = os.path.join(tmp, "box")
        os.makedirs(box)
        first_box = sorted(os.listdir("real_sample_set/box"))[0]
        os.symlink(os.path.join(ROOT, "real_sample_set", "box", first_box),
                   os.path.join(box, first_box))
        cfg_path, _ = cut_config(TRAIN_CONFIG, tmp, epochs=1, synthetic_len=4,
                                 synthetic_val_len=1, ckpt_out=os.path.join(tmp, "best"),
                                 train_state_dir=os.path.join(tmp, "state"),
                                 real_box_test=box)
        fused_conv.launches = 0
        k3_reset()
        res = dfdp_net.main(["--stage", "train", "--data-parallel", "--config", cfg_path,
                             "--device", "cuda", "--out", os.path.join(tmp, "dp")])
        out["data_parallel_k2_launches"] = fused_conv.launches
        k3_count("data_parallel_1card",
                 K3_PER_RENDER["fused"] * out["data_parallel_k2_launches"])
        with open(os.path.join(tmp, "dp", "train.log")) as f:
            log = f.read()
        single = ("data_parallel requested but only one usable device; running "
                  "single-chip")
        print(f"dfdp_net --stage train --data-parallel on one card ({TRAIN_CONFIG} cut to "
              f"1 step, 1 validation item and 1 box scene at 512x768, bs 4): '{single}' logged: "
              f"{single in log}; losses {res['losses']}; K2 launches "
              f"{out['data_parallel_k2_launches']}")
        if not (single in log and len(res["losses"]) == 1
                and np.isfinite(res["losses"]).all()
                and out["data_parallel_k2_launches"] == 3):
            failed.append("--data-parallel on one card")

    ds = SyntheticRGBD((512, 768), length=4, seed=0, train=False, style="v5")
    items = [ds[i] for i in range(4)]
    # without cuDNN on both sides: it picks its convolution algorithms by
    # batch size, and bs 2 against bs 4 then differs by 1.8e-4 of the loss
    # (PERF.md section 6) -- the algorithms', not the split's
    dfdp_spec = {"weights": "sdirt_tpu_torch/weights/rf50mm/Sdirt_best_acc1.npz",
                 "lr": 3e-5, "total_steps": 4, "steps": 1, "config": TRAIN_CONFIG,
                 "cudnn_off": True,
                 "aif": np.stack([i[0] for i in items])[None],
                 "depth": np.stack([i[1] for i in items])[None]}
    one_fit = eq.fit_rank(0, 1, torch.device("cuda"), PAR_FIT)
    # the one-rank step renders the batch in the ranks' halves: cuBLAS may
    # pick other GEMMs for the bf16 PSF network at another row count; the
    # split under test is the step's
    one_dfdp = eq.dfdp_rank(0, 1, torch.device("cuda"), {**dfdp_spec, "render_in": 2})
    torch.backends.cudnn.enabled = True
    t0 = time.perf_counter()
    ranks = launch(eq.sequence, 2, backend="gloo", device="cuda:0",
                   args=([("fit_rank", PAR_FIT), ("dfdp_rank", dfdp_spec)],),
                   timeout=min(300.0, left_s()))
    out["two_rank_seconds"] = time.perf_counter() - t0
    out["two_rank_k1_launches"] = [r[0]["k1_launches"] for r in ranks]
    out["two_rank_k2_launches"] = [r[1]["k2_launches"] for r in ranks]
    for rank, (fit_r, dfdp_r) in enumerate(ranks):
        k3_record(f"dfdp_2rank rank {rank}", dfdp_r["k3_launches"],
                  K3_PER_RENDER["fused"] * dfdp_r["k2_launches"])
        loss_rel = abs(fit_r["losses"][0] - one_fit["losses"][0]) / one_fit["losses"][0]
        par = float(np.abs(fit_r["params"] - one_fit["params"]).max()
                    / np.abs(one_fit["params"]).max())
        terms = {k: abs(dfdp_r["losses"][0][k] - v) / abs(v)
                 for k, v in one_dfdp["losses"][0].items()}
        stats = max(float(np.abs(dfdp_r["batch_stats"][k] - v).max() / np.abs(v).max())
                    for k, v in one_dfdp["batch_stats"].items())
        print(f"rank {rank} of 2 (gloo, both on the one card): fit step (1, 2) at bs 64 x "
              f"20 000 rays, 10 000 traced here: loss {fit_r['losses'][0]!r} (one rank "
              f"{one_fit['losses'][0]!r}, relative diff {loss_rel:.2e}), parameters after "
              f"an SGD step within {par:.2e} of their largest (tolerance {PAR_FIT_RTOL}), "
              f"K1 launches {fit_r['k1_launches']}, step {fit_r['step_ms'][0]:.3f} ms; "
              f"DfDP step (2, 1) at 512x768, bs 2 of 4: loss terms {dfdp_r['losses'][0]} "
              f"(relative diffs {terms}), BN running statistics within {stats:.2e} "
              f"(tolerance {PAR_DFDP_RTOL}), K2 launches {dfdp_r['k2_launches']}, step "
              f"{dfdp_r['step_ms'][0]:.3f} ms")
        if not (loss_rel <= PAR_FIT_RTOL and par <= PAR_FIT_RTOL
                and fit_r["k1_launches"] == 2):
            failed.append(f"rank {rank} fit step")
        if not (max(terms.values()) <= PAR_DFDP_RTOL and stats <= PAR_DFDP_RTOL
                and dfdp_r["k2_launches"] == 1):
            failed.append(f"rank {rank} DfDP step")
    out["one_rank_ms"] = {"fit": one_fit["step_ms"][0], "dfdp": one_dfdp["step_ms"][0]}
    out["two_rank_ms"] = {"fit": [r[0]["step_ms"][0] for r in ranks],
                          "dfdp": [r[1]["step_ms"][0] for r in ranks]}
    print(f"step ms (host clock around a synchronised step): one rank fit "
          f"{one_fit['step_ms'][0]:.3f}, DfDP {one_dfdp['step_ms'][0]:.3f}; two ranks "
          f"{out['two_rank_ms']} -- the two ranks share one card and talk over gloo "
          f"through the host, so these are no multi-GPU speed; the launch took "
          f"{out['two_rank_seconds']:.1f} s with the ranks' start; {smi}")
    if failed:
        raise RuntimeError(f"the multi-GPU paths failed: {failed}")
    return out


# the native PNG/JPEG loader against the JAX engine's CPU run
# (scripts/make_native_reference.py): NEAREST bit-equal; CUBIC within f32
# rounding of two 4-tap passes, per bit depth of the source; the Canon
# items within 1e-6, their depth bit-equal
NATIVE_REF = "sdirt_tpu_torch/reference/native_decode_jax_cpu.npz"
NATIVE_CUBIC_TOL = {8: 1e-4, 16: 0.03}
NATIVE_ITEM_TOL = 1e-6


def np_max_diff(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def host_ms(fn, reps):
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def native_reference_check(native, D):
    """The loader's NEAREST and CUBIC decodes at 96x144 and 256x384 and the
    CanonFlatSet items under the native engine at 256x384, against the JAX
    engine's run on the CPU; returns the largest differences."""
    ref = np.load(NATIVE_REF)
    worst = {"nearest": 0.0, "cubic_8bit": 0.0, "cubic_16bit": 0.0, "items": 0.0}
    for i, rel in enumerate(str(f) for f in ref["files"]):
        bits = int(ref["bits"][i])
        for h, w in ((96, 144), (256, 384)):
            pick = ref[f"pick_{h}x{w}"]
            for name, interp in (("nearest", native.NEAREST), ("cubic", native.CUBIC)):
                key = f"d{i}_{h}x{w}_{name}"
                img, got_bits = native.decode(rel, (h, w), ref[key].shape[0], interp,
                                              return_bit_depth=True)
                tol = 0.0 if name == "nearest" else NATIVE_CUBIC_TOL[bits]
                diff = np_max_diff(img.reshape(img.shape[0], -1)[:, pick], ref[key])
                if f"full{i}_{h}x{w}_{name}" in ref:
                    diff = max(diff, np_max_diff(img, ref[f"full{i}_{h}x{w}_{name}"]))
                mean = np_max_diff(img.astype(np.float64).sum((1, 2)), ref[f"{key}_sum"]) / (h * w)
                kind = name if name == "nearest" else f"cubic_{bits}bit"
                worst[kind] = max(worst[kind], diff)
                if got_bits != bits or not (diff <= tol and mean <= tol):
                    raise RuntimeError(f"native decode of {rel} at {h}x{w} ({name}) is "
                                       f"{diff:.3e} (mean {mean:.3e}) from the JAX engine")
    D.set_image_engine("native")
    ds = D.CanonFlatSet("real_sample_set/flat", resize=(256, 384))
    pick = ref["pick_256x384"]
    for k in range(len(ds)):
        for j, arr in enumerate(ds[k]):
            flat = arr.reshape(arr.shape[0], -1)
            diff = max(np_max_diff(flat[:, pick], ref[f"item{k}_{j}"]),
                       np_max_diff(arr.astype(np.float64).sum((1, 2)),
                                ref[f"item{k}_{j}_sum"]) / flat.shape[1])
            tol = NATIVE_ITEM_TOL
            if j == 2:
                diff, tol = np_max_diff(arr, ref[f"item{k}_{j}_full"]), 0.0
            worst["items"] = max(worst["items"], diff)
            if not diff <= tol:
                raise RuntimeError(f"CanonFlatSet item {k} array {j} under the native "
                                   f"engine is {diff:.3e} from the JAX loader's")
    return worst


def native_phase(smi):
    """Phase 27: the native engine: its PNG/JPEG loader against the numpy
    decoders and the JAX engine's CPU run, load_batch, a bad file, host
    times; its EXR decoder on FlyingThings3D trees as phase 22 writes them,
    against io/exr.py, and the dataset engine switch."""
    from sdirt_tpu_torch import native
    from sdirt_tpu_torch.dfdp import datasets as D
    from sdirt_tpu_torch.io.exr import read_exr
    from sdirt_tpu_torch.io.jpeg import read_jpeg

    out = {"build_seconds": native.build_seconds}
    pngs = sorted(glob.glob("real_sample_set/flat/**/*.png", recursive=True))
    jpgs = sorted(glob.glob("sdirt_tpu_torch/reference/datasets/nyu2_train/*/*.jpg"))
    depth16 = "real_sample_set/casual/orbbec/001/d.png"
    # at the file's own size under NEAREST: the numpy decoders' samples
    for p in pngs + [depth16] + jpgs:
        s = D.read_png(p) if p.endswith(".png") else read_jpeg(p)
        want = np.moveaxis(s[..., None] if s.ndim == 2 else s, -1, 0).astype(np.float32)
        got = native.decode(p, s.shape[:2], want.shape[0], native.NEAREST)
        if not np.array_equal(got, want):
            raise RuntimeError(f"the native decode of {p} differs from the numpy decoder's")
    try:
        out["vs_jax_engine"] = native_reference_check(native, D)
    finally:
        D.set_image_engine("numpy")
    batch = pngs + pngs
    for interp in (native.NEAREST, native.CUBIC):
        got = native.load_batch(batch, (256, 384), 3, interp)
        if not all(np.array_equal(g, native.decode(p, (256, 384), 3, interp))
                   for g, p in zip(got, batch)):
            raise RuntimeError("native.load_batch differs from serial decodes")
    with tempfile.TemporaryDirectory() as tmp:
        bad = os.path.join(tmp, "garbage.jpg")
        with open(bad, "wb") as f:
            f.write(b"\xff\xd8" + np.random.default_rng(0).bytes(4096))
        try:
            native.decode(bad, (64, 96))
            raise RuntimeError("the native loader decoded a garbage file")
        except IOError:
            pass
    n_threads = os.cpu_count() or 1
    out["host_ms"] = {
        "png_512x768_native": host_ms(lambda: native.decode(pngs[0], (512, 768)), 5),
        "png_512x768_numpy": host_ms(lambda: D.read_png(pngs[0]), 3),
        "jpeg_640x480_native": host_ms(lambda: native.decode(jpgs[0], (480, 640)), 5),
        "jpeg_640x480_numpy": host_ms(lambda: read_jpeg(jpgs[0]), 2),
        f"load_batch_16_png_512x768_{n_threads}_threads": host_ms(
            lambda: native.load_batch(batch, (512, 768), n_threads=n_threads), 3),
        "load_batch_16_png_512x768_1_thread": host_ms(
            lambda: native.load_batch(batch, (512, 768), n_threads=1), 2)}
    worst = out["vs_jax_engine"]
    print(f"native loader (g++, zlib only): NEAREST bit-equal to read_png on {len(pngs)} flat "
          f"l/r PNGs and the 16-bit orbbec d.png, to read_jpeg on {len(jpgs)} NYU JPEGs; "
          f"against the JAX engine's CPU run: NEAREST {worst['nearest']:.3e}, CUBIC "
          f"{worst['cubic_8bit']:.3e} (8-bit), {worst['cubic_16bit']:.3e} (16-bit), "
          f"CanonFlatSet items {worst['items']:.3e}; load_batch equal to serial decodes; "
          "a garbage file raised IOError")
    for what, ms in out["host_ms"].items():
        print(f"native loader host ms, {what}: {ms:.2f} ({smi})")
    with tempfile.TemporaryDirectory() as tmp:
        root = write_ft3d_tree(os.path.join(tmp, "ft3d"), 2, 11)
        exrs = sorted(glob.glob(os.path.join(root, "*", "disp.exr")))
        for p in exrs:
            if not np.array_equal(native.decode_exr(p), read_exr(p)):
                raise RuntimeError(f"the native EXR decode differs from io/exr.py on {p}")
        out["native_exr_ms"] = host_ms(lambda: native.decode_exr(exrs[0]), 5)
        out["numpy_exr_ms"] = host_ms(lambda: read_exr(exrs[0]), 5)
        items = {}
        for engine in ("numpy", "native"):
            D.set_image_engine(engine)
            ds = D.FlyingThings3D(root, resize=(512, 768), train=False)
            items[engine] = [ds[i] for i in range(len(ds))]
        D.set_image_engine("numpy")
        same = all(np.array_equal(a, b) for x, y in zip(items["numpy"], items["native"])
                   for a, b in zip(x, y))
    print(f"native EXR decode bit-equal to io/exr.py on {len(exrs)} 960x540 disp.exr "
          f"(ZIP); FlyingThings3D items equal under both engines: {same}; host ms per "
          f"EXR read: native {out['native_exr_ms']:.2f}, numpy {out['numpy_exr_ms']:.2f} "
          f"(both libraries built in {out['build_seconds']:.2f} s beside nvcc)")
    if not same:
        raise RuntimeError("the native engine's items differ from the numpy engine's")
    return out


SINGLE_IMAGE_REF = "sdirt_tpu_torch/reference/single_image_jax_cpu.npz"
SINGLE_IMAGE_TOL = {"max": 2e-3, "mean": 1e-4}


def trace_busy_ms(events):
    """Device busy ms and device activities in a Chrome trace's events: the
    union of its kernel, memcpy and memset intervals (read from the file,
    which is cheaper than key_averages() over ~10^5 events)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, len(spans)


def single_image_phase(fused_trace, fused_conv, smi):
    """Phase 28: render_single_image at its published defaults against the
    JAX package's op-by-op CPU run on the same draws; its trace and conv
    times, rays/s, idle share and memory."""
    from sdirt_tpu_torch.core.constants import GEO_SPP, WAVE_RGB
    from sdirt_tpu_torch.dfdp.datasets import load_rgb
    from sdirt_tpu_torch.dp.psf import compute_psf_rgb
    from sdirt_tpu_torch.optics.sampling import point_source_grid
    from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens
    from sdirt_tpu_torch.render.perpixel import psf_map_conv, render_single_image
    from sdirt_tpu_torch.utils.logging import RaysPerSecond, print_memory, profile_trace

    ref = np.load(SINGLE_IMAGE_REF)
    img = load_rgb(str(ref["image"]))
    if img.astype(np.int64).sum() != int(ref["image_sum"]):
        raise RuntimeError(f"{ref['image']} is not the image the JAX run rendered")
    lens = PSFNetLens("lenses/rf50mm/lens_web.json", model_name="mlp", kernel_size=KS,
                      sensor_res=(512, 768), device="cuda")
    lens.refocus(-1000.0 + lens.d_sensor, xy=ref["refocus_xy"])
    depth, grid, ks = float(ref["depth"]), int(ref["psf_grid"]), int(ref["psf_ks"])
    pupils = [(ref["pupil_main"][i], ref["pupil_chief"][i]) for i in range(len(WAVE_RGB))]
    kw = dict(psf_grid=grid, psf_ks=ks, pupils=pupils)
    out = {"d_sensor_gap_mm": abs(lens.d_sensor - float(ref["d_sensor"]))}

    fused_trace.launches = fused_conv.launches = 0
    k3_reset()
    got = render_single_image(lens, img, depth, **kw)
    torch.cuda.synchronize()
    k3_count("single_image", 0)
    if (fused_trace.launches, fused_conv.launches) != (0, 0):
        raise RuntimeError("the single-image render launched K1 or K2")
    if got.device.type != "cuda" or tuple(got.shape) != (512, 768, 3):
        raise RuntimeError(f"the render is {tuple(got.shape)} on {got.device}")
    host = got.cpu().numpy()
    if not np.isfinite(host).all():
        raise RuntimeError("the single-image render is not finite")
    picked = host.reshape(-1, 3)[ref["pick"]]
    gap = np.abs(picked - ref["values"])
    out["max_abs_err"], out["mean_abs_err"] = float(gap.max()), float(gap.mean())
    out["channel_sum_err"] = np_max_diff(host.astype(np.float64).sum((0, 1)),
                                         ref["channel_sum"]) / (512 * 768)
    out["jax_jit_vs_op_by_op_max"] = np_max_diff(ref["values_jit"], ref["values"])
    out["vs_jax_jit_max"] = np_max_diff(picked, ref["values_jit"])

    pts = point_source_grid(depth=depth, grid=grid).reshape(-1, 3)
    n_rays = len(pts) * len(WAVE_RGB) * 2 * GEO_SPP       # main + chief bundles
    psfs = compute_psf_rgb(lens, pts, None, ks=ks + 1, pupils=pupils)
    psf_sum = psfs.double().sum((-1, -2)).cpu().numpy()
    out["psf_sum_err"] = np_max_diff(psf_sum, ref["psf_sum"])
    out["psf_sum_rel_err"] = float((np.abs(psf_sum - ref["psf_sum"]) / ref["psf_sum"]).max())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    ctr = RaysPerSecond()
    with ctr.measure(n_rays):
        start.record()
        compute_psf_rgb(lens, pts, None, ks=ks + 1, pupils=pupils)
        end.record()
        torch.cuda.synchronize()
    out["rays_per_s"] = ctr.rays_per_sec
    out["trace_ms"] = start.elapsed_time(end)
    psfs = psfs / (psfs.sum((-1, -2), keepdim=True) + 1e-9)
    psf_map = psfs.reshape(grid, grid, 3, ks + 1, ks + 1).permute(2, 0, 3, 1, 4).reshape(
        3, grid * (ks + 1), grid * (ks + 1))
    img_t = torch.from_numpy(img).cuda().float()[None] / 255.0
    out["conv_ms"] = cuda_time_ms(lambda: psf_map_conv(img_t, psf_map, grid), 5)

    out["render_ms"] = cuda_time_ms(lambda: render_single_image(lens, img, depth, **kw),
                                    1, warmup=0)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        with profile_trace(tmp) as prof:
            start.record()
            render_single_image(lens, img, depth, **kw)
            end.record()
        with open(prof.trace_path) as f:
            events = json.load(f)["traceEvents"]
    out["profiled_render_ms"] = start.elapsed_time(end)
    busy, out["kernels"] = trace_busy_ms(events)
    out["device_busy_ms"] = busy
    out["idle_share"] = 1 - busy / out["profiled_render_ms"] if out["kernels"] else None
    # the profiler's host cost lengthens the profiled call: the same busy
    # time against the unprofiled call's length bounds the share from below
    out["idle_share_unprofiled"] = 1 - busy / out["render_ms"] if out["kernels"] else None
    out["trace_events"] = len(events)
    if not events:
        raise RuntimeError("profile_trace wrote an empty trace")
    idle, idle_unprofiled = (
        ("not measured (the trace holds no device activity)",) * 2 if not out["kernels"]
        else (f"{out['idle_share']:.1%}", f"{out['idle_share_unprofiled']:.1%}"))
    print(f"single-image render (rf50mm at 1 m, 512x768 at {depth:g} mm, psf_grid {grid}, "
          f"psf_ks {ks} -> {ks + 1}): vs the JAX CPU run op by op max |diff| "
          f"{out['max_abs_err']:.3e}, mean {out['mean_abs_err']:.3e}, channel sums "
          f"{out['channel_sum_err']:.3e} per pixel (limits {SINGLE_IMAGE_TOL['max']:g} / "
          f"{SINGLE_IMAGE_TOL['mean']:g}); vs its jitted run {out['vs_jax_jit_max']:.3e} "
          f"(JAX jitted vs op by op {out['jax_jit_vs_op_by_op_max']:.3e}); PSF sums "
          f"{out['psf_sum_err']:.3e} ({out['psf_sum_rel_err']:.3e} relative); d_sensor "
          f"{out['d_sensor_gap_mm']:.3e} mm; K1 and K2 not launched")
    print(f"single-image render times ({smi}): PSF map trace {out['trace_ms']:.2f} ms "
          f"({n_rays} rays, {out['rays_per_s']:.4g} rays/s), psf_map_conv "
          f"{out['conv_ms']:.3f} ms, the whole render {out['render_ms']:.2f} ms; under "
          f"profile_trace {out['profiled_render_ms']:.2f} ms with the device busy "
          f"{busy:.2f} ms in {out['kernels']} kernels and copies (idle share {idle}, from "
          f"the {len(events)} events of its Chrome trace; against the unprofiled call "
          f"{idle_unprofiled})")
    print_memory("single-image render:")
    if not (out["max_abs_err"] <= SINGLE_IMAGE_TOL["max"]
            and out["mean_abs_err"] <= SINGLE_IMAGE_TOL["mean"]
            and out["channel_sum_err"] <= SINGLE_IMAGE_TOL["mean"]):
        raise RuntimeError("the single-image render disagrees with the JAX CPU run")
    return out


def main():
    os.chdir(ROOT)
    # a hang inside a phase is cut here, not only checked between phases
    signal.signal(signal.SIGALRM, _out_of_time)
    signal.alarm(int(BUDGET_S))
    # -- 0. device ---------------------------------------------------------
    t = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    from sdirt_tpu_torch import dfdp_net, fit_psfnet
    from sdirt_tpu_torch.dp import fused_trace
    from sdirt_tpu_torch.dp.psf import dp_psf_fused, lens_scalars, object_points
    from sdirt_tpu_torch.optics.lens import Lens
    from sdirt_tpu_torch.optics.sampling import sample_from_points
    from sdirt_tpu_torch.psfnet.surrogate import PSFNetLens
    from sdirt_tpu_torch.psfnet.train import (create_train_state, make_eval_fn,
                                              make_train_step)
    from sdirt_tpu_torch.render import fused_conv
    from sdirt_tpu_torch import native
    from sdirt_tpu_torch.utils import kernels
    from sdirt_tpu_torch.render.mlp_fast import mlp_psf_tapmajor
    from sdirt_tpu_torch.render.pipeline import query_points
    from sdirt_tpu_torch.render.camera import degamma

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=min(60.0, left_s()), check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    print("TF32 off for matmul and cuDNN convolutions")
    phase("0 device", t)

    # -- 1. build ----------------------------------------------------------
    t = time.perf_counter()
    cpu_plans = {lens_name: fused_trace.make_fused_plan(Lens(
        f"lenses/{lens_name}/lens_web.json", sensor_res=(512, 768), device="cpu"))
        for lens_name in ("rf50mm", "rf35mm")}
    probes = start_k1_probes(list(cpu_plans.values()), kernels.BUILD_DIR)
    # the native engine's g++ build runs beside the nvcc builds
    native_build = {}

    def build_native():
        try:
            native.build(timeout=left_s(), reuse=False)
        except Exception as e:  # noqa: BLE001 - raised below, in the main thread
            native_build["error"] = e

    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    kernels.build(timeout=left_s(), reuse=False)
    native_thread.join(timeout=left_s())
    if "error" in native_build or native_thread.is_alive():
        raise RuntimeError(f"the native engine did not build: {native_build.get('error')}")
    print(f"nvcc: {len(kernels.SOURCES)} sources in parallel, "
          f"{kernels.build_seconds:.2f} s; g++ (native EXR decoder and PNG/JPEG "
          f"loader) beside them, "
          f"{native.build_seconds:.2f} s")
    for src, log in kernels.build_log.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "stack",
                                       "Compiling")):
                print(f"ptxas {src}: {line.strip()}")
    sass_per_ray = k1_sass_report(cpu_plans, probes)
    for lens_name, plan in cpu_plans.items():
        print(f"K1 {lens_name}: {fused_trace.ops_per_ray(plan)} f32 operations per ray "
              f"(the bound's count) against {sass_per_ray[lens_name][1]} SASS instructions "
              f"(plain arithmetic everywhere: {sass_per_ray[lens_name][0]}); the first "
              f"{fused_trace.exact_surfaces(plan)} of {len(plan.surfaces)} surfaces "
              "traced exact")
    smem_fn = kernels.library("fused_dp_conv").fused_dp_conv_smem_bytes
    for c in fused_conv.CHANNELS:
        for ks in (KS, fused_conv.max_ks(c)):
            got = smem_fn(c, ks)
            print(f"K2 shared memory per block, C {c}, ks {ks}: {got} B "
                  f"(limit {fused_conv.SMEM_LIMIT} B)")
            if got != fused_conv.smem_bytes(c, ks):
                raise RuntimeError("csrc/fused_dp_conv.cu and render/fused_conv.py "
                                   "disagree on the tile's shared memory")
    phase("1 build", t)

    # -- 2. K2 vs plain -------------------------------------------------------
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    diffs = {}
    for shape in ((1, 512, 768, 3), (4, 512, 768, 3), (1, 500, 750, 3), (2, 64, 96, 3)):
        img, psf = conv_inputs(gen, *shape, KS)
        got = fused_conv.fused_dp_conv_tapmajor(img, psf, KS)
        ref = fused_conv.fused_dp_conv_tapmajor_ref(img, psf, KS)
        torch.cuda.synchronize()
        diffs[shape] = max_diff(got, ref)
        print(f"K2 vs plain {shape} ks {KS}: max |diff| {diffs[shape]:.3e}")
        if not diffs[shape] <= KERNEL_TOL:
            raise RuntimeError(f"K2 disagrees with its plain version at {shape}")
        del img, psf, got, ref
    phase("2 K2 vs plain", t)

    # -- 3. serve path -------------------------------------------------------
    t = time.perf_counter()
    with open(os.path.join(ROOT, "sdirt_tpu_torch", "reference",
                           "stage_sample_jax_cpu.json")) as f:
        ref = json.load(f)
    with tempfile.TemporaryDirectory() as out:
        fused_conv.launches = 0
        k3_reset()
        result = dfdp_net.main(["--stage", "sample", "--config",
                                "configs/dfdp_by_sdirt_rf50mm.yml",
                                "--device", "cuda", "--out", out])
        launches = fused_conv.launches
        k3_count("serve", K3_PER_RENDER["fused"] * launches)
    print(f"K2 launches on the serve path: {launches}")
    if launches <= 0:
        raise RuntimeError("the serve path did not launch K2")
    check_serve_path("rf50mm", result, ref)
    phase("3 serve path", t)

    # -- 4. K2 times ---------------------------------------------------------
    t = time.perf_counter()
    args = dfdp_net.load_config("configs/dfdp_by_sdirt_rf50mm.yml")
    _, lens = dfdp_net.get_lens(args, device="cuda")
    f4, f20, depth = dfdp_net.get_flat_sample_set(args)[0]
    img = torch.from_numpy(f20[None, :3]).cuda()
    dist = torch.from_numpy(-depth[None] * 1e3).cuda()
    with torch.no_grad():
        o = query_points(dist, lens.d_sensor, lens.d_min, lens.d_max)
        psf_tm = mlp_psf_tapmajor(lens.net, o, KS)
        lum = degamma(img.permute(0, 2, 3, 1)).contiguous()
        n, h, w, c = lum.shape
        got = fused_conv.fused_dp_conv_tapmajor(lum, psf_tm, KS)
        ref_out = fused_conv.fused_dp_conv_tapmajor_ref(lum, psf_tm, KS)
        main_diff = max_diff(got, ref_out)
        print(f"K2 vs plain on the serve path's own inputs: {main_diff:.3e} "
              f"(luminance up to {float(lum.max()):.2f})")
        worst_pixel(psf_tm, KS, got, ref_out)
        del got, ref_out
        if not main_diff <= KERNEL_TOL:
            raise RuntimeError("K2 disagrees with its plain version on the serve inputs")
        k2_ms = cuda_time_ms(lambda: fused_conv.fused_dp_conv_tapmajor(lum, psf_tm, KS), 50)
        plain_ms = cuda_time_ms(
            lambda: fused_conv.fused_dp_conv_tapmajor_ref(lum, psf_tm, KS), 3, 1)
        mlp_ms = cuda_time_ms(lambda: mlp_psf_tapmajor(lens.net, o, KS), 10)
        render_ms = cuda_time_ms(lambda: lens.render(img, dist, None), 10)
        net = dfdp_net.build_basenet(dfdp_net.ported_weights(
            args["train"]["dfdpnet_pretrained"]), device="cuda")
        stack = torch.from_numpy(f4[None]).cuda()
        depth_ms = cuda_time_ms(lambda: dfdp_net.dfdp_infer(net, stack), 10)
    bound_ms, bound_by = k2_bound_ms(n, h, w, c, KS)
    print(f"K2 fused_dp_conv_tapmajor: {k2_ms:.4f} ms per launch "
          f"(bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / k2_ms:.1%} of it); "
          f"the first version: {EARLIER_MS['K2 serve']} ms "
          f"({bound_ms / EARLIER_MS['K2 serve']:.1%})")
    print(f"K2 plain version: {plain_ms:.3f} ms")
    print("library_ms: none -- no single PyTorch call computes a spatially "
          "varying per-pixel convolution")
    print(f"bf16 PSF MLP (torch.mm): {mlp_ms:.3f} ms; render call: "
          f"{render_ms:.3f} ms; depth-net frame 512x768: {depth_ms:.3f} ms")
    phase("4 K2 times", t)

    # -- 5. K1 vs plain ------------------------------------------------------
    t = time.perf_counter()
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_check = {}
    for lens_name in ("rf50mm", "rf35mm"):
        lens = Lens(f"lenses/{lens_name}/lens_web.json", sensor_res=(512, 768),
                    device="cuda")
        print(f"K1 on {lens_name} ({lens.stack.num_surfaces} surfaces, "
              f"{fused_trace.ops_per_ray(fused_trace.make_fused_plan(lens))} "
              "f32 operations per ray):")
        k1_check[lens_name] = k1_vs_plain(lens, rng, gen)
    phase("5 K1 vs plain", t)

    # -- 6. fit path ---------------------------------------------------------
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        fused_trace.launches = 0
        fit = fit_psfnet.main(FIT_ARGS + ["--result-dir", out])
        k1_launches = fused_trace.launches
        print(f"K1 launches on the fit path: {k1_launches}")
        if k1_launches <= 0:
            raise RuntimeError("the fit path did not launch K1")
        losses = np.array(fit["losses"])
        print(f"fit: {len(losses)} steps, losses {losses[0]:.6f} -> "
              f"{losses[-1]:.6f} (first 5 mean {losses[:5].mean():.6f}, last 5 "
              f"mean {losses[-5:].mean():.6f}); evals {fit['evals']}; d_sensor "
              f"{fit['d_sensor']:.6f}; host seconds {fit['seconds']}")
        if not (np.isfinite(losses).all() and losses[-5:].mean() < losses[:5].mean()):
            raise RuntimeError("the fit's loss is not finite or did not fall")
        if not all(np.isfinite(e[1:]).all() for e in fit["evals"]):
            raise RuntimeError("the fit's eval is not finite")
        fitted = PSFNetLens("lenses/rf50mm/lens_web.json", kernel_size=KS,
                            sensor_res=(512, 768), device="cuda")
        fitted.load_net(os.path.join(out, "psfnet_mlp.npz"))
        analysis = analysis_check(fit, out, fitted)
    f4, f20, depth = dfdp_net.get_flat_sample_set(args)[0]
    dof = fitted.render(f20[None, :3], -depth[None] * 1e3, None)
    print(f"render with the fitted net: {tuple(dof.shape)}, range "
          f"[{float(dof.min()):.4f}, {float(dof.max()):.4f}]")
    if dof.shape != (1, 6, 512, 768) or not bool(torch.isfinite(dof).all()):
        raise RuntimeError("the fitted surrogate does not render")
    del fitted, dof
    phase("6 fit path", t)

    # -- 7. shipped surrogate vs JAX -----------------------------------------
    t = time.perf_counter()
    with open(os.path.join(ROOT, "sdirt_tpu_torch", "reference",
                           "fit_psfnet_jax_cpu.json")) as f:
        fit_ref = json.load(f)
    lens = PSFNetLens("lenses/rf50mm/lens_web.json", kernel_size=KS,
                      sensor_res=(512, 768), device="cuda")
    lens.load_net("sdirt_tpu_torch/weights/rf50mm/F4_PSFNet_mlp.npz")
    lens.refocus(-1000.0 + lens.d_sensor)
    eval_fn = make_eval_fn(lens, bs=1024, spp=65536, ks=KS)
    l1, l2 = (float(v) for v in eval_fn(lens.net, gen))
    for k, v in (("d_sensor", lens.d_sensor), ("eval_l1", l1), ("eval_l2", l2)):
        st = fit_ref["stats"][k]
        d = v - st["mean"]
        print(f"shipped surrogate {k}: {v!r} (JAX CPU mean {st['mean']!r}, "
              f"spread {st['spread']:.3e}, diff {d:+.3e}, tolerance {st['tolerance']:.3e})")
        if not (np.isfinite(v) and abs(d) <= st["tolerance"]):
            raise RuntimeError(f"shipped surrogate {k} off the JAX reference")
    phase("7 shipped surrogate", t)

    # -- 8. K1 and fit times -------------------------------------------------
    t = time.perf_counter()
    plan = fused_trace.make_fused_plan(lens)
    sc = lens_scalars(lens)
    pts = torch.from_numpy(bench_points(rng, 64)).cuda()
    k1_ms, plain1_ms, bundles = {}, {}, {}
    for tag, spp, n_pts, shrink in (("main", 20000, 64, 1.0), ("chief", 2048, 64, 0.25),
                                    ("eval chunk", 65536, 128, 1.0)):
        chunk_pts = pts if n_pts == 64 else torch.from_numpy(bench_points(rng, n_pts)).cuda()
        r = bundles[tag] = sample_from_points(object_points(chunk_pts, sc), spp,
                                              sc["pupilz"], sc["pupilr"] * shrink, gen)
        k1_ms[tag] = cuda_time_ms(
            lambda: fused_trace.fused_trace_sensor(r, lens.d_sensor, plan), 50)
        plain1_ms[tag] = cuda_time_ms(
            lambda: fused_trace.fused_trace_sensor_ref(r, lens.d_sensor, plan), 5, 1)
    # the wrapper's host time per call, at the chief bundle: launches
    # enqueued back to back, no synchronisation inside the window
    r = bundles["chief"]
    for _ in range(20):
        fused_trace.fused_trace_sensor(r, lens.d_sensor, plan)
    torch.cuda.synchronize()
    t_host = time.perf_counter()
    for _ in range(200):
        fused_trace.fused_trace_sensor(r, lens.d_sensor, plan)
    wrapper_us = (time.perf_counter() - t_host) / 200 * 1e6
    torch.cuda.synchronize()
    ops = fused_trace.ops_per_ray(plan)
    k1_bound, k1_by = k1_bound_ms(20000 * 64, ops)
    chief_bound, chief_by = k1_bound_ms(2048 * 64, ops)
    chunk_bound, _ = k1_bound_ms(65536 * 128, ops)
    with torch.no_grad():
        psf_ms = cuda_time_ms(lambda: dp_psf_fused(
            pts, gen, sc, plan, spp=20000, spp_chief=2048, ks=KS, chunk=2048), 20)
    state = create_train_state(lens.net, 1e-4, 90000)
    step_fn = make_train_step(lens, bs=64, spp=20000, ks=KS)
    step_ms = cuda_time_ms(lambda: step_fn(state, gen), 20)
    eval_ms = cuda_time_ms(lambda: eval_fn(lens.net, gen), 2, 1)
    print(f"K1 fused_trace_sensor ({ops} f32 operations per ray): main 20000x64 "
          f"{k1_ms['main']:.4f} ms per launch (bound {k1_bound:.4f} ms by {k1_by}, "
          f"{k1_bound / k1_ms['main']:.1%} of it); chief 2048x64 {k1_ms['chief']:.4f} ms "
          f"(bound {chief_bound:.4f} ms by {chief_by})")
    print(f"K1 eval chunk 65536x128: {k1_ms['eval chunk']:.4f} ms per launch (bound "
          f"{chunk_bound:.4f} ms, {chunk_bound / k1_ms['eval chunk']:.1%} of it)")
    print(f"K1 wrapper, chief bundle: {wrapper_us:.1f} us of host time per call")
    print(f"K1 plain version: main {plain1_ms['main']:.3f} ms, chief "
          f"{plain1_ms['chief']:.3f} ms, eval chunk {plain1_ms['eval chunk']:.3f} ms")
    print("library_ms: none -- no PyTorch call traces rays through a lens")
    print(f"trace+splat (dp_psf_fused, 64 points x (20000 + 2048) rays, ks {KS}): "
          f"{psf_ms:.3f} ms, {64 * 22048 / psf_ms * 1e3:.4e} rays/s")
    print(f"fit: train step {step_ms:.3f} ms, eval 1024 x 65536 rays "
          f"{eval_ms:.3f} ms (CUDA events)")
    k1_dev = {}
    for tag, bound in (("main", k1_bound), ("chief", chief_bound), ("eval chunk", chunk_bound)):
        r = bundles[tag]
        rows, _ = device_profile(
            lambda: fused_trace.fused_trace_sensor(r, lens.d_sensor, plan), 20)
        k1_rows = [x for x in rows if "fused_trace_kernel" in x[0]]
        if k1_rows:
            k1_dev[tag] = k1_rows[0][2] / k1_rows[0][1]
            earlier = EARLIER_MS.get(f"K1 {tag}")
            print(f"K1 {tag} bundle, device time per launch (profiler): "
                  f"{k1_dev[tag]:.4f} ms, {bound / k1_dev[tag]:.1%} of its bound "
                  f"(CUDA events over wrapper calls: {k1_ms[tag]:.4f} ms)"
                  + (f"; the first version: {earlier} ms ({bound / earlier:.1%})"
                     if earlier else ""))
    del bundles
    for what, fn, reps, wall in (("train step", lambda: step_fn(state, gen), 10, step_ms),
                                 ("eval", lambda: eval_fn(lens.net, gen), 1, eval_ms)):
        print_profile(what, *device_profile(fn, reps), reps, wall)
    phase("8 K1 times", t)

    # -- 9. training path ----------------------------------------------------
    t = time.perf_counter()
    train_stats = training_phase(dfdp_net, fused_conv, smi)
    phase("9 training path", t)

    # -- 10. train-step reference ---------------------------------------------
    t = time.perf_counter()
    train_ref = train_step_reference(dfdp_net)
    phase("10 train-step reference", t)

    # -- 11. render variants ---------------------------------------------------
    t = time.perf_counter()
    from sdirt_tpu_torch import gate_render_variants

    with open(os.path.join(ROOT, "sdirt_tpu_torch", "reference",
                           "render_variants_jax_cpu.json")) as f:
        variant_ref = json.load(f)
    variant_rows, k2_by_gate, failed = {}, {}, []
    for lens_name in ("rf50mm", "rf35mm"):
        jax_rows = {k: mean_scores(v)
                    for k, v in variant_ref["lenses"][lens_name]["rows"].items()}
        for net in GATE_ROWS:
            rows, k2_by_gate[lens_name, net], row_failed = gate_rows(
                gate_render_variants, fused_conv, lens_name, net, jax_rows)
            failed += row_failed
            for r in rows:
                variant_rows[f"{lens_name} {net} {r['variant']}"] = {
                    k: r[k] for k in ("psnr_l", "psnr_r", "ssim_l", "ssim_r",
                                      "perc_l", "perc_r", "k2_launches")}
    k2_int8 = sum(v["k2_launches"] for k, v in variant_rows.items()
                  if k.endswith(" fused_int8"))
    print(f"K2 launches on the fused_int8 path: {k2_int8} (of {sum(k2_by_gate.values())} "
          "in the gate's runs)")
    if k2_int8 <= 0:
        failed.append("the fused_int8 path did not launch K2")
    if failed:
        raise RuntimeError(f"render variants off the JAX reference: {failed}")
    variant_stats = variant_times(dfdp_net, fused_conv, smi)
    phase("11 render variants", t)

    # -- 12. rf35mm serve path --------------------------------------------------
    t = time.perf_counter()
    with open(os.path.join(ROOT, "sdirt_tpu_torch", "reference",
                           "stage_sample_rf35mm_jax_cpu.json")) as f:
        ref35 = json.load(f)
    with tempfile.TemporaryDirectory() as out:
        fused_conv.launches = 0
        k3_reset()
        result35 = dfdp_net.main(["--stage", "sample", "--config",
                                  "configs/dfdp_by_sdirt_rf35mm.yml",
                                  "--device", "cuda", "--out", out])
        launches35 = fused_conv.launches
        k3_count("serve_rf35mm", K3_PER_RENDER["fused"] * launches35)
    print(f"K2 launches on the rf35mm serve path: {launches35}")
    if launches35 <= 0:
        raise RuntimeError("the rf35mm serve path did not launch K2")
    check_serve_path("rf35mm", result35, ref35)
    phase("12 rf35mm serve path", t)

    # -- 13. K2 at ks 35 -------------------------------------------------------
    t = time.perf_counter()
    k2_35 = k2_ks35(fused_conv, kernels)
    phase("13 K2 at ks 35", t)

    # -- 14. F/1.8 serve path --------------------------------------------------
    t = time.perf_counter()
    f18 = serve_f18(dfdp_net, fused_conv, smi)
    phase("14 F/1.8 serve path", t)

    # -- 15. far-field A/B -----------------------------------------------------
    t = time.perf_counter()
    ab = farfield_ab(fused_conv)
    phase("15 far-field A/B", t)

    # -- 16. deblur ------------------------------------------------------------
    t = time.perf_counter()
    deblur = deblur_phase(dfdp_net, fused_conv, smi)
    phase("16 deblur", t)

    # -- 17. multi-focus stack and thin lens -------------------------------------
    t = time.perf_counter()
    stack = stack_phase(dfdp_net, fused_conv, smi)
    phase("17 stack and thin lens", t)

    # -- 18. mlpconv and siren fits ----------------------------------------------
    t = time.perf_counter()
    heads = fit_heads_phase(fit_psfnet, fused_trace, PSFNetLens, create_train_state,
                            make_train_step, smi)
    phase("18 mlpconv and siren fits", t)

    # -- 19. baselines -----------------------------------------------------------
    t = time.perf_counter()
    base = baselines_phase(PSFNetLens)
    phase("19 baselines", t)

    # -- 20. coherent demo ---------------------------------------------------------
    t = time.perf_counter()
    coherent = coherent_phase(Lens)
    phase("20 coherent demo", t)

    # -- 21. lens design -------------------------------------------------------------
    t = time.perf_counter()
    design = lens_design_phase()
    phase("21 lens design", t)

    # -- 22. the published configuration's training ---------------------------------
    t = time.perf_counter()
    real = real_data_phase(dfdp_net, fused_conv, smi)
    phase("22 published training", t)

    # -- 23. the depth-side tools ------------------------------------------------------
    t = time.perf_counter()
    tools = depth_tools_phase(fused_conv, fused_trace)
    phase("23 depth-side tools", t)

    # -- 24. the basis-student distillation -------------------------------------------
    t = time.perf_counter()
    distilled = distill_phase(fused_trace, smi)
    phase("24 distillation", t)

    # -- 25. the rf35mm student gate ----------------------------------------------------
    t = time.perf_counter()
    gate35 = student_gate_phase(fused_conv, smi)
    phase("25 student gate", t)

    # -- 26. multi-GPU ----------------------------------------------------------------
    t = time.perf_counter()
    multi = multi_gpu_phase(dfdp_net, fit_psfnet, fused_conv, fused_trace, smi)
    phase("26 multi-GPU", t)

    # -- 27. the native engine ----------------------------------------------------------
    t = time.perf_counter()
    native_stats = native_phase(smi)
    phase("27 native engine", t)

    # -- 28. single-image render --------------------------------------------
    t = time.perf_counter()
    single = single_image_phase(fused_trace, fused_conv, smi)
    phase("28 single-image render", t)

    # -- 29. result ----------------------------------------------------------
    if kernels.builds != 1:
        raise RuntimeError(f"the kernels were built {kernels.builds} times in one process")
    err = max([main_diff, train_stats["k2"]["max_abs_err"],
               variant_stats["k2_int8"]["max_abs_err"], k2_35["max_abs_err"],
               *diffs.values()])
    k2_paths = {"serve": launches, "train": train_stats["k2_launches"],
                "fused_int8": k2_int8, "serve_rf35mm": launches35,
                "serve_f18": f18["launches"], "farfield_ab": ab["launches"],
                "deblur": deblur["sample_launches"] + deblur["train_launches"],
                "stack": stack["launches"], "published_train": real["k2_launches"],
                "eval_depth_ckpt": tools["eval_k2_launches"],
                "student_gate": sum(r["k2_launches"] for r in gate35.values()),
                "data_parallel_1card": multi["data_parallel_k2_launches"],
                "dfdp_2rank": sum(multi["two_rank_k2_launches"])}
    k1_err = max(v[0] for v in k1_check.values())
    k1_paths = {"fit_analysis": k1_launches,
                **{f"fit_{m}": v["k1_launches"] for m, v in heads.items()},
                "disparity_probe_traced": tools["probe_k1_launches"],
                "distill_eval": distilled["k1_launches"],
                "probe_teacher_l1": distilled["probe_k1_launches"],
                "fit_mesh_1x1": sum(multi["mesh_k1_launches"]),
                "fit_2rank": sum(multi["two_rank_k1_launches"])}
    print(json.dumps({"kernels": [{
        "name": "fused_trace_sensor", "route": "cuda",
        "source": "sdirt_tpu_torch/csrc/fused_trace.cu",
        "replaces": "sdirt_tpu/dp/fused_trace.py:310",
        "launches": sum(k1_paths.values()), "launches_by_path": k1_paths,
        "max_abs_err": k1_err,
        "ra_mismatches": sum(v[2] for v in k1_check.values()),
        "psf_l1_max": max([v[5] for v in k1_check.values()]
                          + [tools["probe_k1_vs_plain"]["l1_max"]]),
        "ms": k1_dev.get("main", k1_ms["main"]), "plain_ms": plain1_ms["main"],
        "bound_ms": k1_bound,
        "bound_by": k1_by, "library_ms": None}, {
        "name": "fused_dp_conv_tapmajor", "route": "cuda",
        "source": "sdirt_tpu_torch/csrc/fused_dp_conv.cu",
        "replaces": "sdirt_tpu/render/fused_conv_pallas.py:81",
        "launches": sum(k2_paths.values()), "launches_by_path": k2_paths,
        "max_abs_err": err, "max_abs_diff": err,
        "ms": k2_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "train_shape": train_stats["k2"], "fused_int8_psf": variant_stats["k2_int8"],
        "ks35": k2_35}, {
        "name": "dense_bf16_relu", "route": "cuda",
        "source": "sdirt_tpu_torch/csrc/dense_bf16.cu", "replaces": None,
        "launches": sum(v[0] for v in K3_PATHS.values()),
        "launches_by_path": {p: v[0] for p, v in K3_PATHS.items()},
        "layers": variant_stats["k3"],
        **{key: sum(r[key] for r in variant_stats["k3"]["mlp"])
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")}}],
        "train": {k: v for k, v in train_stats.items() if k not in ("k2",)},
        "train_step_reference": train_ref,
        "variants": {"gate": variant_rows, "render": variant_stats["render"],
                     "parts_ms": variant_stats["parts_ms"],
                     "int8_trunk_card_vs_cpu": variant_stats["trunk_card_vs_cpu"]},
        "serve_f18": f18, "farfield_ab": ab, "deblur": deblur, "stack": stack,
        "analysis": analysis, "fit_heads": heads, "baselines": base,
        "coherent": coherent, "lens_design": design, "published_train": real,
        "depth_tools": tools, "distill": distilled, "student_gate": gate35,
        "multi_gpu": multi, "native": native_stats, "single_image": single},
        default=float))
    print(smi)
    k3_off = {p: v for p, v in K3_PATHS.items() if v[0] != v[1]}
    if k3_off:
        raise RuntimeError(f"K3 launches off what the renders call for, (got, want): {k3_off}")
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
