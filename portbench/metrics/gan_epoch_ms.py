"""One train_gan call's time over its GAN epochs, ms (host clock)."""


def read(run):
    return run.window.seconds / run.window.units * 1e3
