"""host loop: kernel launches on the card in the traced window (every
stream's CUDA kernels, copies and sets not counted) over the frames that
the streams completed in it."""


def read(run):
    if not run.traced or not run.frames:
        return None
    return run.launches / run.frames
