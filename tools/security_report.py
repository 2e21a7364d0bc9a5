#!/usr/bin/env python
"""Print the concrete-security audit table for every registered parameter
set (provenance for docs/SECURITY.md).

Pure host-side math — no JAX device work; runs in ~seconds.  Columns:
core-SVP classical (conservative), gate-model bits (what public 128-bit
claims use), the limiting level, and the noiseless-discretization flag
(docs/SECURITY.md explains the Uint2-8 finding).

Usage: python tools/security_report.py [--json]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from zig_tfhe_jax import params as P                      # noqa: E402
from zig_tfhe_jax.utils.security import (estimate_dual_lwe,  # noqa: E402
                                         estimate_params)


def main():
    as_json = "--json" in sys.argv
    sets = P.ALL_PARAMS + (P.SECURITY_128_BIT_T64, P.SECURITY_128_BIT_V2)
    rows = []
    for p in sets:
        ep = estimate_params(p)
        lim = ep.lv0 if ep.limiting_level == "lv0" else ep.lv1
        dual = estimate_dual_lwe(lim.n, lim.q_bits, lim.sigma_rel)
        rows.append({
            "set": p.name,
            "claimed": p.security_bits,
            "core_svp_classical": round(ep.classical_bits, 1),
            "dual_cross_check": round(dual.classical_bits, 1),
            "gate_bits": round(min(ep.lv0.gate_bits, ep.lv1.gate_bits), 1)
            if ep.classical_bits > 0 else 0.0,
            "limited_by": ep.limiting_level,
            "lv0_beta": ep.lv0.beta,
            "lv1_beta": ep.lv1.beta,
            "noiseless_lv1": ep.lv1.noiseless_discretized,
        })
    if as_json:
        print(json.dumps(rows))
        return
    hdr = (f"{'set':<12}{'claimed':>8}{'core-SVP':>10}{'dual':>8}"
           f"{'gates':>8}{'limit':>7}  flags")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        flag = "lv1 NOISELESS (0-bit)" if r["noiseless_lv1"] else ""
        print(f"{r['set']:<12}{r['claimed']:>8}"
              f"{r['core_svp_classical']:>10}{r['dual_cross_check']:>8}"
              f"{r['gate_bits']:>8}{r['limited_by']:>7}  {flag}")
    print("\nmodels: core-SVP classical = 0.292*beta (primal uSVP); "
          "dual = distinguishing-dual cross-check; "
          "gates = 0.292*beta + 16.4 + log2(8d).  docs/SECURITY.md.")


if __name__ == "__main__":
    main()
