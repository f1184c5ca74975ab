"""``setup_s``: seconds from the process's start to the window's: imports,
loading the data, building the model, the extensions' build or load, the
graphs' capture and the warm-up (host clock)."""


def read(run):
    return run["setup_s"]
