"""The device seconds of the traced steps' optimizer kernels (the
executor's ``egt.executor.kernel`` spans of phase ``optimizer``: the
kernels that write a parameter or Adam's state) over the device seconds
of the steps' target runs (``egt.executor.run``), in %; each kernel's
device seconds run from one CUDA event at its start to one at its
end."""

from portbench import spans


def read(run):
    return spans.device_share(run, lambda a: a.get("phase") == "optimizer")
