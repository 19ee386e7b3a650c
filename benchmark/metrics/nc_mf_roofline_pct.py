"""Share of its roofline (%) of the matched-filter scores of CONFIG_1-4's
receive in the profiled stretch: the least time the noncoherent scan's and
the refinement's work could take, counted from the configuration's launch
shapes at the rows of the program's `rx.nc_scan` spans
(benchmark/nc_scan.py), over the device time of every operation of the
matched-filter kernel that keeps each hypothesis's scores
(dmf_wgmma_kernel<false, ...>, deep_mf_score). None where the program has
no such span or runs no such operation."""

from benchmark import nc_scan, spans

NAME = "dmf_wgmma_kernel<false"


def read(run):
    st = spans.stretch(run)
    if st is None:
        return None
    bound = sum(nc_scan.scan_bound_ms(int(n)) + nc_scan.refine_bound_ms(int(n))
                for n in st.n[st.of("rx.nc_scan")])
    busy_ms = sum(e - s for n, s, e in run.trace.device_ops
                  if NAME in n) * 1e-3
    return 100.0 * bound / busy_ms if bound and busy_ms else None
