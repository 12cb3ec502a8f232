"""Share of the ingest memos' lookups in the window that this process's
memos answered: ``TELEMETRY``'s ``memo`` counts at the ``process`` level,
of the prepared streams, their device uploads and the alignment seed,
over every lookup (the others read the disk or prepared afresh).  Nothing
where the program has no such counters, or looked nothing up."""


def read(ctx):
    memo = ctx["telemetry"].get("memo")
    if not memo:
        return None
    lookups = sum(sum(levels.values()) for levels in memo.values())
    hits = sum(levels["process"] for levels in memo.values())
    return hits / lookups if lookups else None
