"""The ROI kernel's share of its roofline over the profiled batches: the
least time its launches could take (``frozen/roofline.roi_launch`` from the
boxes each launch got: bytes over the memory rate or float32 operations
over the float32 peak, the larger) over the device time of
``roi_sample_kernel``."""

from portbench.frozen.flops import card_peaks
from portbench.frozen.roofline import bound_s, roi_launch


def read(run):
    p = run.prof
    peaks = card_peaks(run.device_kind)
    t = sum(s for n, s in p["kernels"].items() if "roi_sample_kernel" in n)
    if not peaks or not t or not p["roi_launches"]:
        return None
    need = sum(bound_s(*roi_launch(b, sub, shape[1], shape[2], R), peaks)
               for b, sub, shape, R in p["roi_launches"])
    return 100.0 * need / t
