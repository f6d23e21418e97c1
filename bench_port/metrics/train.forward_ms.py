"""Host wall of the program's train_step/forward span per profiled step."""


def read(run):
    walls = run.trace.span_seconds("train_step/forward") if run.trace else []
    return 1e3 * sum(walls) / len(walls) if walls else None
