"""The window's time over its GAN epochs, ms (host clock): one train_gan call
of whole log windows (``loss_every`` epochs, each ended by the loop's own
sync), every epoch and every stall in it counted."""


def read(run):
    return run.window.seconds / run.window.units * 1e3
