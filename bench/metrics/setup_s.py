"""setup_s: from the start of the run to the end of set-up (imports, the
kernels' build or load, the inputs, the program's set-up and the check's
drive), in s."""


def read(records: dict) -> float | None:
    return records["setup_s"]
