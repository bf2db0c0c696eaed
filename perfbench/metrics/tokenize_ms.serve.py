"""Tokenizer (Cosmos encode): mean of run_clip's tokenize seconds over the
window's batches, in ms."""


def read(layer):
    xs = [b["tokenize_s"] for b in layer.get("batches", [])]
    return 1e3 * sum(xs) / len(xs) if xs else None
