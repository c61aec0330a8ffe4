"""Pose-only Gauss-Newton (`_pose_gn_refine`: the polish, the motion prior, the final refine) in every offline stage, milliseconds a frame on the host: the stage clock's `<stage>/gn` spans."""

from slambench import spans


def read(ctx):
    return spans.span_ms(ctx, "gn")
