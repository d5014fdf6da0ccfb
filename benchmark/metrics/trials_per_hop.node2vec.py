"""Proposals the walks drew a hop: ``NODE2VEC_COUNTS``'s proposals over its
hops (a walker's hop on the first-order step draws one; a rejection round
a panel for every walker of the hop, open or not), median over the
window's unprofiled traced jobs.  The work the rejection sampler spends
for one accepted hop."""

from statistics import median


def read(rec):
    xs = [s["n_proposals"] / s["n_hops"] for s in rec["stages"] if s.get("n_hops", 0) > 0
          and "n_proposals" in s]
    return median(xs) if xs else None
