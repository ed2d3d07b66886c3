"""The share of the traced window in which no device activity runs: one
minus the union of the activities' intervals over the window."""


def read(facts, cell):
    if facts.window_s <= 0 or not facts.activities:
        return None
    return 100.0 * (1.0 - facts.busy_s / facts.window_s)
