"""The window's wall time less the sum of its steps, per epoch, in ms:
validation, the schedule's and the loop's bookkeeping at each epoch's end,
and the checkpoint write on exit with its wait."""


def read(run):
    s, epochs = run.values.get("step_seconds"), run.values.get("epochs")
    if not s or not epochs:
        return None
    return 1e3 * (run.window_s - sum(s)) / epochs
