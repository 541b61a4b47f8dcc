"""The device-to-host fetch's rate (GB/s): the bytes the pipeline fetches,
computed by the driver from the contract's shapes and storage dtype, over
the device time of the trace's device-to-host copies."""


def read(ctx: dict) -> float | None:
    lo, hi = ctx["window"]
    spent = sum(e - s for name, s, e in ctx["dev"]
                if "Memcpy DtoH" in name and s >= lo and e <= hi)
    nbytes = sum(b["fetch_bytes"] for b in ctx["batches"])
    return nbytes / spent / 1e9 if spent > 0 and nbytes > 0 else None
