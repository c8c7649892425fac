"""host loop: the frames whose step re-detected (`FrameOutput.fallback`)
over the frames completed in the window, for pipelines with a re-detect
gate."""


def read(run):
    if run.fallback_frames is None or not run.frames:
        return None
    return 100.0 * run.fallback_frames / run.frames
