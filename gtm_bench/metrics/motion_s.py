"""motion_s (s an encode; layer motion: pipeline/predict.py, motion.py):
the span around predict_motion, mean over the window's encodes."""


def read(run):
    return run.span_mean("predict_motion")
