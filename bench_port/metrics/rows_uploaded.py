"""Node rows written to the device-resident state a gang, from the
``device_state_rows_uploaded_total`` counter across the window."""


def read(run):
    g = run["gangs"]
    return run["rows_uploaded"] / len(g) if g else None
