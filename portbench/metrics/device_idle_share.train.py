"""Share of a traced session of training steps in which no kernel, copy or
memset ran on the device, in percent."""

from portbench.readings import idle_share


def read(ctx):
    return idle_share(ctx)
