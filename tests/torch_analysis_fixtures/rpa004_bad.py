"""Seeded RPA004 violations: dict-order-dependent keys and artifacts (the
reference's rule, unchanged in the port)."""
import json


def unstable_key(d):
    return tuple(d.items())  # RPA004: insertion order leaks into the key


def unstable_dump(d, fh):
    json.dump(d, fh)  # RPA004: no sort_keys=True
