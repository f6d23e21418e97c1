"""Host wall of the program's train_step/backward span per profiled step."""


def read(run):
    walls = run.trace.span_seconds("train_step/backward") if run.trace else []
    return 1e3 * sum(walls) / len(walls) if walls else None
