"""fused_decompress_roofline (%): B3's least time (peaks.b3_bound: the kept
slots and the fit read, the chunk written, the decode and the irfft's flops)
over its device time, a launch each, in the traced window, for
ceil(parameters / 4096) rows of keep slots."""

from perfbench import peaks

KERNEL = "fused_decompress_kernel"  # the CUDA function of the repro_torch::fused_decompress op


def read(record):
    seconds, calls = record["kernel_device_s"].get(KERNEL), record["kernel_calls"].get(KERNEL)
    if not seconds or not calls or record.get("theta") is None:
        return None
    least_ms, _ = peaks.b3_bound(peaks.chunk_rows(record["n_params"]), peaks.keep(record["theta"]))
    return 100.0 * calls * least_ms / 1e3 / seconds
