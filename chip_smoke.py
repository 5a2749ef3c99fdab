#!/usr/bin/env python3
"""Drive the PyTorch port (sdirt_tpu_torch) on one NVIDIA card and check it.

  python3 chip_smoke.py

Phases, each printing its elapsed seconds:
  0. device: a CUDA card is required (no CPU fallback); TF32 is switched off
     for matmuls and convolutions, so the depth net runs in full f32;
  1. build: the fused DP conv kernel (K2) is compiled with nvcc from
     sdirt_tpu_torch/csrc/ and its -Xptxas -v report printed;
  2. kernel vs plain: K2 against its plain PyTorch version on seeded inputs
     at the serve shape (1x512x768x3, ks 21), a ragged shape and a batch of 2;
  3. serve path: ``python -m sdirt_tpu_torch.dfdp_net --stage sample`` on
     real_sample_set/ with the exported weights, through its main(); K2's
     launch count is read around it, and the scores are held against the
     JAX package's CPU numbers (sdirt_tpu_torch/reference/);
  4. times (CUDA events, after warm-up): K2, its plain version, one render
     call and one depth-net frame at 512x768;
  5. the kernels line, then the card's name and power limit, then the
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
BUDGET_S = 540.0
KS = 21
# Both versions sum the same exact f32 products of bf16 inputs in the same
# order; they differ in how the tap sums are reduced and in the divide
# (reciprocal times sum in the kernel), a few f32 ulps of the output. The
# serve path's linear luminance reaches degamma(1) = 1153, where one ulp is
# 1.2e-4, so 1e-3 is about 8 ulps there and ~10^4 ulps on [0, 1] inputs.
KERNEL_TOL = 1e-3
PSNR_TOL_DB = 0.1      # the JAX package's render-variant gate
DEPTH_TOL = 0.005
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


def main():
    os.chdir(ROOT)
    # a hang inside a phase is cut here, not only checked between phases
    signal.signal(signal.SIGALRM, _out_of_time)
    signal.alarm(int(BUDGET_S))
    # -- 0. device ---------------------------------------------------------
    t = time.perf_counter()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    from sdirt_tpu_torch import dfdp_net
    from sdirt_tpu_torch.render import fused_conv
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
    fused_conv.build(timeout=left_s())
    for line in fused_conv.build_log.splitlines():
        if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
            print(f"ptxas: {line.strip()}")
    phase("1 build", t)

    # -- 2. kernel vs plain --------------------------------------------------
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
    phase("2 kernel vs plain", t)

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

    # -- 4. times ------------------------------------------------------------
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
    phase("4 times", t)

    # -- 5. result -----------------------------------------------------------
    if fused_conv.builds != 1:
        raise RuntimeError(f"K2 was built {fused_conv.builds} times in one process")
    err = max([main_diff, *diffs.values()])
    print(json.dumps({"kernels": [{
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
