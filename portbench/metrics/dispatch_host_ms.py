"""Host time of the engine's dispatch per chunk in the traced window: the
program's ``engine.pack``, ``engine.cache``, ``engine.upload``,
``engine.replay`` and ``engine.decode`` spans (not ``engine.fetch``, the
wait on the card), summed, over the chunks replayed (``engine.replay``
spans)."""

from portbench import spans

STAGES = ("engine.pack", "engine.cache", "engine.upload", "engine.replay",
          "engine.decode")


def read(run):
    got = spans.window(run)
    if got is None:
        return None
    chunks = len(spans.named(got, "engine.replay"))
    if not chunks:
        return None
    return sum(s.dur_s for s in spans.named(got, *STAGES)) / chunks * 1e3
