"""RPA004-clean twin: order-independent keys and artifacts."""
import json


def stable_key(d):
    return tuple(sorted(d.items()))


def stable_dump(d, fh):
    json.dump(d, fh, sort_keys=True)
