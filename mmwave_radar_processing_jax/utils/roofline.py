"""Peak rates per device and on-card calibration.

``bench.py`` takes FLOP and byte counts from the compiled executable's own
``cost_analysis()`` and divides the achieved rates by the device's entry in
:data:`PEAKS`.
"""

from __future__ import annotations

import subprocess

#: Published dense peaks, keyed by ``jax.Device.device_kind``.  Source:
#: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense (no sparsity),
#: at the full 700 W power limit: 67 TFLOP/s float32 (CUDA cores), 495
#: TF32, 989 bf16 (tensor cores), 3.35 TB/s HBM3.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_tflops": 67.0,
        "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
        "hbm_gbs": 3350.0,
    },
}


def device_peaks(device_kind: str) -> dict:
    """The :data:`PEAKS` entry for ``device_kind``; unknown kinds raise."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add its "
            "data-sheet figures to utils/roofline.PEAKS") from None


def card_power_limit() -> str:
    """``name, power.limit`` of the card as ``nvidia-smi`` reports them.

    Read by a child process, so the caller's JAX state is never touched.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def measure_peaks(*, matmul_n: int = 8192, copy_mb: int = 1024,
                  iters: int = 20, repeats: int = 5) -> dict:
    """What the attached card reaches on a large bf16 matmul and a large copy.

    Published peaks are upper bounds no program reaches; a kernel's share of
    these measured rates says more about the kernel.  Each repetition times
    ``iters`` dependent calls ended in ``jax.block_until_ready``; the best
    repetition is reported.

    - **matmul**: ``[n, n] x [n, n]`` bf16 with float32 accumulation
      (``2 n^3`` FLOPs each).
    - **copy**: ``y = x + 1`` over a float32 array of ``copy_mb`` MB
      (read + write = ``2 * bytes`` of traffic).
    """
    import time

    import jax
    import jax.numpy as jnp

    def best_seconds(fn, x):
        x = jax.block_until_ready(fn(x))  # compile + execute once
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            for _ in range(iters):
                x = fn(x)
            jax.block_until_ready(x)
            best = min(best, (time.perf_counter() - t0) / iters)
        return best

    @jax.jit
    def mm(a):
        return jnp.dot(a, a, preferred_element_type=jnp.float32).astype(
            jnp.bfloat16)

    a = jax.random.normal(jax.random.PRNGKey(0), (matmul_n, matmul_n),
                          jnp.bfloat16)
    bf16_tflops = 2.0 * matmul_n**3 / best_seconds(mm, a) / 1e12

    @jax.jit
    def copy(x):
        return x + 1.0

    n_elems = copy_mb * (1 << 20) // 4
    x = jnp.zeros((n_elems,), jnp.float32)
    hbm_gbs = 2.0 * 4.0 * n_elems / best_seconds(copy, x) / 1e9
    return {"measured_bf16_tflops": bf16_tflops,
            "measured_copy_gbs": hbm_gbs,
            "matmul_n": matmul_n, "copy_mb": copy_mb}


def classify_bound(
    tflops: float, gbs: float, *, peak_tflops: float, peak_gbs: float,
) -> str:
    """'compute' / 'bandwidth' / 'dispatch' from achieved vs peak rates.

    If neither engine exceeds 10% of peak the pipeline is dominated by
    dispatch/launch/queue overheads rather than either hardware roof.
    """
    mfu = tflops / peak_tflops
    hbm = gbs / peak_gbs
    if max(mfu, hbm) < 0.10:
        return "dispatch"
    if hbm > 1.0 >= mfu:
        # nominal bytes exceed physical bandwidth: the byte count bills
        # fusion-reused operands (e.g. CFAR's shifted slices) as HBM traffic
        return "bandwidth (nominal bytes; on-chip reuse)"
    return "compute" if mfu >= hbm else "bandwidth"
