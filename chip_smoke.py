#!/usr/bin/env python3
"""Drive the PyTorch port (sdirt_tpu_torch) on one NVIDIA card and check it.

  python3 chip_smoke.py

Phases, each printing its elapsed seconds:
  0. device: a CUDA card is required (no CPU fallback); TF32 is switched off
     for matmuls and convolutions, so the depth net, the splat and the PSF
     MLP run in full f32;
  1. build: both CUDA kernels (K1 fused trace, K2 fused DP conv) are
     compiled with nvcc from sdirt_tpu_torch/csrc/, in parallel, and their
     -Xptxas -v reports printed;
  2. K2 vs plain: K2 against its plain PyTorch version on seeded inputs at
     the serve shape (1x512x768x3, ks 21), a ragged shape and a batch of 2;
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
     65536 rays) for 21 steps, through its main(); K1's launch count is
     read around it, the loss must fall, and the fitted net is loaded into
     a serve-path PSFNetLens that renders one flat scene;
  7. shipped surrogate: the fit's lens and eval (K1 ground truth) on the
     exported F4_PSFNet_mlp, held against the JAX package's CPU numbers
     (sdirt_tpu_torch/reference/fit_psfnet_jax_cpu.json);
  8. K1 times (CUDA events, after warm-up): K1 and its plain version at both
     bundles, trace+splat rays/s at bench.py's shape, a train step, an eval;
  9. the kernels line, then the card's name and power limit, then the
     result line.
Any failure raises: the exit code is then not 0 and no result line is
printed.
"""

import json
import os
import signal
import subprocess
import sys
import tempfile
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
            "--eval-spp", "65536", "--skip-analysis"]
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
F32_FLOPS = 67e12               # H100 SXM, f32 outside the tensor cores

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


def bench_points(rng, n):
    """bench.py's field points: x, y uniform on [-1, 1], depth uniform on
    [-20000, -200] mm."""
    return np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                     -(rng.uniform(0, 1, n) * 19800 + 200)], -1).astype(np.float32)


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
        print(f"  K1 vs plain {spp}x{n} (pupil x{shrink}): live {float(live.float().mean()):.4f}, "
              f"ra mismatches {mism} of {rays.ra.numel()}, max |px/py diff| "
              f"{dxy:.3e} mm, max |x_tan diff| {dxt:.3e}")
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
    kernels.build(timeout=left_s())
    print(f"nvcc: {len(kernels.SOURCES)} sources in parallel, "
          f"{kernels.build_seconds:.2f} s")
    for src, log in kernels.build_log.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "stack",
                                       "Compiling")):
                print(f"ptxas {src}: {line.strip()}")
    phase("1 build", t)

    # -- 2. K2 vs plain -------------------------------------------------------
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    diffs = {}
    for shape in ((1, 512, 768, 3), (1, 500, 750, 3), (2, 64, 96, 3)):
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
        result = dfdp_net.main(["--stage", "sample", "--config",
                                "configs/dfdp_by_sdirt_rf50mm.yml",
                                "--device", "cuda", "--out", out])
        launches = fused_conv.launches
    print(f"K2 launches on the serve path: {launches}")
    if launches <= 0:
        raise RuntimeError("the serve path did not launch K2")
    ref_flat = {r["distance_mm"]: r for r in ref["flat"]}
    for rec in result["flat"]:
        r = ref_flat[rec["distance_mm"]]
        for k in ("psnr_l", "psnr_r"):
            d = rec[k] - r[k]
            print(f"flat {rec['distance_mm']} mm {k}: {rec[k]:.4f} dB "
                  f"(JAX CPU {r[k]:.4f}, diff {d:+.4f})")
            if not (np.isfinite(rec[k]) and abs(d) <= PSNR_TOL_DB):
                raise RuntimeError(f"flat {k} off the JAX reference")
        print(f"flat {rec['distance_mm']} mm ssim_l/r: {rec['ssim_l']:.4f} "
              f"{rec['ssim_r']:.4f} (JAX CPU {r['ssim_l']:.4f} {r['ssim_r']:.4f})")
    if len(result["flat"]) != len(ref_flat):
        raise RuntimeError("flat scene count differs from the reference")
    for tag, m in result["depth"].items():
        for k, v in ref["depth"][tag].items():
            d = m[k] - v
            print(f"depth {tag} {k}: {m[k]:.6f} (JAX CPU {v:.6f}, diff {d:+.2e})")
            if not (np.isfinite(m[k]) and abs(d) <= DEPTH_TOL):
                raise RuntimeError(f"depth {tag} {k} off the JAX reference")
    print(f"serve path host seconds: {result['seconds']}")
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
          f"(bound {bound_ms:.4f} ms by {bound_by}, {bound_ms / k2_ms:.1%} of it)")
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
    k1_ms, plain1_ms = {}, {}
    for tag, spp, shrink in (("main", 20000, 1.0), ("chief", 2048, 0.25)):
        r = sample_from_points(object_points(pts, sc), spp, sc["pupilz"],
                               sc["pupilr"] * shrink, gen)
        r = r.replace(o=r.o.contiguous())
        k1_ms[tag] = cuda_time_ms(
            lambda: fused_trace.fused_trace_sensor(r, lens.d_sensor, plan), 50)
        plain1_ms[tag] = cuda_time_ms(
            lambda: fused_trace.fused_trace_sensor_ref(r, lens.d_sensor, plan), 5, 1)
    ops = fused_trace.ops_per_ray(plan)
    k1_bound, k1_by = k1_bound_ms(20000 * 64, ops)
    chief_bound, chief_by = k1_bound_ms(2048 * 64, ops)
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
    print(f"K1 plain version: main {plain1_ms['main']:.3f} ms, chief "
          f"{plain1_ms['chief']:.3f} ms")
    print("library_ms: none -- no PyTorch call traces rays through a lens")
    print(f"trace+splat (dp_psf_fused, 64 points x (20000 + 2048) rays, ks {KS}): "
          f"{psf_ms:.3f} ms, {64 * 22048 / psf_ms * 1e3:.4e} rays/s")
    print(f"fit: train step {step_ms:.3f} ms, eval 1024 x 65536 rays "
          f"{eval_ms:.3f} ms (CUDA events)")
    k1_dev = {}
    for tag, spp, shrink in (("main", 20000, 1.0), ("chief", 2048, 0.25)):
        r = sample_from_points(object_points(pts, sc), spp, sc["pupilz"],
                               sc["pupilr"] * shrink, gen)
        r = r.replace(o=r.o.contiguous())
        rows, _ = device_profile(
            lambda: fused_trace.fused_trace_sensor(r, lens.d_sensor, plan), 20)
        k1_rows = [x for x in rows if "fused_trace_kernel" in x[0]]
        if k1_rows:
            k1_dev[tag] = k1_rows[0][2] / k1_rows[0][1]
            bound = k1_bound if tag == "main" else chief_bound
            print(f"K1 {tag} bundle, device time per launch (profiler): "
                  f"{k1_dev[tag]:.4f} ms, {bound / k1_dev[tag]:.1%} of its bound "
                  f"(CUDA events over wrapper calls: {k1_ms[tag]:.4f} ms)")
    for what, fn, reps, wall in (("train step", lambda: step_fn(state, gen), 10, step_ms),
                                 ("eval", lambda: eval_fn(lens.net, gen), 1, eval_ms)):
        print_profile(what, *device_profile(fn, reps), reps, wall)
    phase("8 K1 times", t)

    # -- 9. result -----------------------------------------------------------
    if kernels.builds != 1:
        raise RuntimeError(f"the kernels were built {kernels.builds} times in one process")
    err = max([main_diff, *diffs.values()])
    k1_err = max(v[0] for v in k1_check.values())
    print(json.dumps({"kernels": [{
        "name": "fused_trace_sensor", "route": "cuda",
        "source": "sdirt_tpu_torch/csrc/fused_trace.cu",
        "replaces": "sdirt_tpu/dp/fused_trace.py:310",
        "launches": k1_launches, "max_abs_err": k1_err,
        "ra_mismatches": sum(v[2] for v in k1_check.values()),
        "psf_l1_max": max(v[5] for v in k1_check.values()),
        "ms": k1_dev.get("main", k1_ms["main"]), "plain_ms": plain1_ms["main"],
        "bound_ms": k1_bound,
        "bound_by": k1_by, "library_ms": None}, {
        "name": "fused_dp_conv_tapmajor", "route": "cuda",
        "source": "sdirt_tpu_torch/csrc/fused_dp_conv.cu",
        "replaces": "sdirt_tpu/render/fused_conv_pallas.py:81",
        "launches": launches, "max_abs_err": err, "max_abs_diff": err,
        "ms": k2_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(smi)
    signal.alarm(0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
