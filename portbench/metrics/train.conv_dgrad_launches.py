"""Convolutions a step whose input gradient comes from the
``conv3d_dgrad`` kernel (``models/nn.conv3d_dgrad``): the tracer's counter
``conv3d.dgrad``, which ``nn.conv3d`` adds to each time it routes a bf16
stride-1 convolution whose input needs a gradient through the kernel, one
launch in the step's backward (``program_trace.counter``).

A coverage count, not a cost: it should equal the stem's stride-1
convolutions (2 in both training cells), so higher is better; a lower
reading means a convolution left the kernel for cuDNN's path. None for a
program without the kernel, whose convolutions count nothing."""

from portbench.program_trace import counter

_count = counter("conv3d.dgrad")


def read(run):
    from lipreading_tpu_torch.models import nn

    if not hasattr(nn, "conv3d_dgrad"):
        return None
    return _count(run)
