"""Decode (Cosmos decoder to uint8 on the host): mean of the host clock
around decode_video_tokens, whose copy to the host synchronises, in ms."""


def read(layer):
    xs = [b["decode_s"] for b in layer.get("batches", [])]
    return 1e3 * sum(xs) / len(xs) if xs else None
