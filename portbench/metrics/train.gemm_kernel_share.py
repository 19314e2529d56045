"""The device seconds of the traced steps' contractions that the einsum
path ran on B1's Hopper mainloop (``egt.executor.kernel`` spans whose
``path`` is ``einsum-b1``) over the device seconds of the steps' target
runs (``egt.executor.run``), in %; 0 where no kernel took that path."""

from portbench import spans


def read(run):
    return spans.device_share(run, lambda a: a.get("path") == "einsum-b1")
