"""Seconds the program's ``engine.quantize`` spans took while the engine
was built: the int8 engine's host quantization of the seeded floating tree
(the driver turns the program's tracer on around the build and keeps
those spans). None where the program opens no such span."""


def read(run):
    spans = run.records.get("quantize_spans")
    if not spans:
        return None
    return sum(dur for dur, _attrs in spans)
