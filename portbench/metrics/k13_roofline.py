"""k13_roofline (%): K13's share of its roofline, the least time the card
could take for the work of any stable sort of the sample's rows, over the
device time of K13's launches (its histograms and digit passes).

Bytes of one sort of ``entries`` keys (each input byte read once and each
output byte written once):

- with positions: 4 (key in) + 4 (key out) + 8 (int64 position out) = 16 B
  an entry;
- keys alone (``sort_rows_keys``): 4 + 4 = 8 B an entry.

A sort is one ``radix_histogram`` launch; one with positions ends in the
``radix_digit_pass<true, true>`` launch. Every sort of these cells sorts
the rows of the parameters one call takes, ``params x (draws x chains)``
entries over the calls a pass makes (one, or one a parameter slice). Bound by
bytes at the card's HBM rate (``peaks.json``); K13's own design moves 68 B
an entry, which this share does not credit.
"""

from portbench.readers import device_s, matching, peaks

WITH_POSITIONS_B = 16
KEYS_ONLY_B = 8


def sort_bytes(entries: int, sorts: int, with_positions: int) -> int:
    return entries * (WITH_POSITIONS_B * with_positions
                      + KEYS_ONLY_B * (sorts - with_positions))


def read(ctx):
    pk = peaks(ctx)
    ev = matching(ctx, ("radix_histogram", "radix_digit_pass"))
    if pk is None or not ev:
        return None
    sorts = sum("radix_histogram" in e[0] for e in ev)
    with_pos = sum("radix_digit_pass<true, true>" in e[0] for e in ev)
    c = ctx.config
    entries = c["params"] * c["draws"] * c["chains"] // ctx.calls_a_pass
    nbytes = sort_bytes(entries, sorts, with_pos)
    return 100.0 * nbytes / pk["hbm_bytes_per_s"] / device_s(ev)
