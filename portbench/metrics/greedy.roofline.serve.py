"""The CTC-greedy kernel's share of its roofline over the profiled
batches: the least time its launches could take
(``frozen/roofline.greedy_launch`` from each launch's shape and lengths)
over the device time of ``ctc_greedy_kernel``."""

from portbench.frozen.flops import card_peaks
from portbench.frozen.roofline import bound_s, greedy_launch


def read(run):
    p = run.prof
    peaks = card_peaks(run.device_kind)
    t = sum(s for n, s in p["kernels"].items() if "ctc_greedy_kernel" in n)
    if not peaks or not t or not p["greedy_launches"]:
        return None
    need = sum(bound_s(*greedy_launch(*shape, lens.cpu().numpy()), peaks)
               for shape, lens in p["greedy_launches"])
    return 100.0 * need / t
