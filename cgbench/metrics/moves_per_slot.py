"""moves_per_slot: paired VW moves delegation executed
(CGResult.telemetry.executed), a mean over the window's slots."""


def read(rec):
    if not rec.moves:
        return None
    return sum(rec.moves) / len(rec.moves)
