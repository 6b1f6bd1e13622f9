"""loop_infer_share: the stream loop's ``infer`` seconds over its wall, in
%, from the ``stage timing`` line the port's ``StageTimer`` logs: the main
thread feeding ``BatchedStepper``, dispatching and waiting on the device."""

LAYER = "stream loop"
MOVES = "fps"


def read(run):
    if "infer" not in run.stage or not run.stage.get("wall"):
        return None
    return 100.0 * run.stage["infer"] / run.stage["wall"]
