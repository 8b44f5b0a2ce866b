"""95th percentile, over the documents finished in the window, of the time
from submitting a document's ``prepare`` task to its ``score`` result
reaching the harness."""
import numpy as np


def read(rec):
    lat = rec.get("latency_s")
    if rec["kind"] != "score" or not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))
