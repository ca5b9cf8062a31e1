"""The CTC lattice kernels' share of their roofline over the profiled
steps: the least time of both launches of each step
(``frozen/roofline.ctc_work`` from the step's lengths and labels) over
the device time of ``ctc_fwd_kernel`` and ``ctc_bwd_kernel``."""

from portbench.frozen.flops import card_peaks
from portbench.frozen.roofline import bound_s


def read(run):
    p = run.prof
    peaks = card_peaks(run.device_kind)
    t = sum(s for n, s in p["kernels"].items()
            if "ctc_fwd_kernel" in n or "ctc_bwd_kernel" in n)
    if not peaks or not t:
        return None
    need = sum(bound_s(*w[k], peaks) for w in p["ctc_launches"]
               for k in ("fwd", "bwd"))
    return 100.0 * need / t
