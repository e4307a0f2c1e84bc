"""Benchmark suite at the reference problem scales.

The reference's benchmark set (pgp2, cep, 4node, baa99, lands3, storm,
fleet1, fleet2, ssn, 20term, baa99-20 — sd_experiments.sh:21, README.md:57-59)
lives in the unmounted spAlgorithms/spInput repository, so the exact SMPS data
is unavailable here.  This module provides *scale-faithful* stand-ins: for
each suite member a generated instance with the same stage dimensions, number
of random variables, and randomness type (RHS / cost), so throughput and
convergence behavior are measured at the real problem sizes.  Tiny classical
instances with public data (lands, pgp2like) live in models/instances.py.

Dimensions below are the published sizes of the SIPLIB/spInput instances
(first-stage rows x cols, second-stage rows x cols, #RVs):

    name        m1 x n1     m2 x n2      RVs   randomness
    cep1like     9 x 8      7 x 15        3    RHS (demand)
    pgp2scale    2 x 4      7 x 16        3    RHS
    baa99like    ~ x 2      8 x 11        2    RHS (demand); -20 variant: 20
    4nodelike   14 x 52    74 x 186      12    RHS
    20termlike   3 x 63   124 x 764      40    RHS
    ssnlike      1 x 89   175 x 706      86    RHS
    stormlike   59 x 121  528 x 1259    118    RHS
    fleet1like   ~        small fleet     ~    RHS + cost (v2.0 path)

All generated instances have complete recourse (high-cost surplus columns)
and nonnegative costs, so the TRIVIAL lower bound applies — the same
structure class as the reference suite (network/dispatch recourse).
"""

from __future__ import annotations

from stochasticdecomposition_torch.models.synthetic import parse_synthetic

# name -> kwargs for models.synthetic.random_two_stage
SUITE = {
    # small classical scale
    "cep1like": dict(seed=101, n1=8, m1=9, n2=15, m2=7, n_rv=3, support=6),
    "baa99like": dict(seed=102, n1=2, m1=1, n2=11, m2=8, n_rv=2, support=9),
    "baa99-20like": dict(seed=103, n1=20, m1=1, n2=60, m2=40, n_rv=20,
                         support=5, rand_d=4),
    "lands3like": dict(seed=104, n1=4, m1=2, n2=12, m2=7, n_rv=3, support=3),
    "fleet1like": dict(seed=105, n1=10, m1=4, n2=40, m2=20, n_rv=8,
                       support=4, rand_d=4),
    # tiny random-cost member with ENUMERABLE support (3^4 = 81 scenarios):
    # the exact-parity oracle for the v2.0 basis/phi/psi path on device
    "fleetminilike": dict(seed=110, n1=4, m1=2, n2=8, m2=5, n_rv=2,
                          support=3, rand_d=2),
    # mid scale
    "4nodelike": dict(seed=106, n1=52, m1=14, n2=186, m2=74, n_rv=12,
                      support=5),
    "20termlike": dict(seed=107, n1=63, m1=3, n2=764, m2=124, n_rv=40,
                       support=2),
    # large scale
    "ssnlike": dict(seed=108, n1=89, m1=1, n2=706, m2=175, n_rv=86,
                    support=5),
    "stormlike": dict(seed=109, n1=121, m1=59, n2=1259, m2=528, n_rv=118,
                      support=5),
    # High-variance storm-class variant: same dimensions, wider discrete
    # supports (9-point) with 8x the spread, so the statistical stop needs
    # thousands of samples at nominal tolerance — the long-horizon regime
    # (MAX_ITER 5000, SCAN_LEN-deep pi_ratio histories) the reference's
    # real storm data exercises (config.sd MAX_ITER; VERDICT r3 item 4).
    "stormhvlike": dict(seed=109, n1=121, m1=59, n2=1259, m2=528, n_rv=118,
                        support=9, rv_spread=8.0),
}


def load_suite_instance(name: str):
    """Generate + parse a suite instance; returns (core, time, stoc)."""
    return parse_synthetic(**SUITE[name])
