"""loop_encode_share: the stream loop's ``encode`` seconds over its wall,
in %, from the port's ``StageTimer``: the main thread handing frames to
``AsyncSink``, high when the host's interleave thread sets the pace."""

LAYER = "stream loop"
MOVES = "fps"


def read(run):
    if "encode" not in run.stage or not run.stage.get("wall"):
        return None
    return 100.0 * run.stage["encode"] / run.stage["wall"]
