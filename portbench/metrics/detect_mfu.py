"""The detector's FLOPs per traced upload, counted at the image's resized
size padded to a multiple of 32 (what the input needs, not the 1344
canvas the program pads to), over the image's extraction kernel time
times the card's float32 peak, in percent."""

from portbench.bounds import PEAK_F32_FLOPS, detector_flops, padded_input
from portbench.harness import load_module


def read(run):
    tr = run.records.get("trace")
    sizes = run.records.get("traced_upload_sizes")
    if tr is None or not sizes:
        return None
    times = load_module("metrics", "detect_ms").per_image_s(tr)
    n = min(len(times), len(sizes))
    if n == 0:
        return None
    d = run.config["detector"]
    flops = sum(detector_flops(d, *padded_input(w, h, d))
                for w, h in sizes[:n])
    return 100.0 * flops / (sum(times[:n]) * PEAK_F32_FLOPS)
