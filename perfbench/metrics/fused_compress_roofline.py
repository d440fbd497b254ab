"""fused_compress_roofline (%): B2's least time (the larger of its bytes over
the HBM rate and its operations over the fp32 rates, peaks.b2_bound) over
its device time, a launch each, in the traced window; the work counted is
what the gradient's chunks need: ceil(parameters / 4096) rows, 2049 bins,
keep = round((1 - theta) x 2049) slots read and written."""

from perfbench import peaks

KERNEL = "fused_compress_kernel"  # the CUDA function of the repro_torch::fused_compress op


def read(record):
    seconds, calls = record["kernel_device_s"].get(KERNEL), record["kernel_calls"].get(KERNEL)
    if not seconds or not calls or record.get("theta") is None:
        return None
    k = peaks.keep(record["theta"])
    least_ms, _ = peaks.b2_bound(peaks.chunk_rows(record["n_params"]), peaks.BINS, k, k)
    return 100.0 * calls * least_ms / 1e3 / seconds
