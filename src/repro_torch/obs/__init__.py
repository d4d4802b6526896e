"""Observability for the port (see README.md in this package): the
counterpart of the reference's `repro.obs`.

  * spans   — `obs.span("serve.wave", bucket=4)` context managers that
              record a hierarchical trace (Chrome trace-event export)
              through the serving engine, the PTQ pipeline, the EdgeVM
              and the `.capsbin` export;
  * metrics — `MetricsRegistry` counters/gauges/histograms with labeled
              series and one `snapshot()` dict (`CudaBackend.fallbacks`
              and the serving registry's counts are views over them);
  * numerics — `obs.numerics` probes the numeric health of the
              quantized stack (saturation, int32 clips, bound
              tightness, q7-vs-f32 SNR) under the same ambient, free-
              when-off contract;
  * `obs.analyze` reads traces, metrics and numerics docs back, and
    `obs.baseline` gates `repro.bench/v1` documents.
"""
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, METRICS,  # noqa: F401
                                     Counter, Gauge, Histogram,
                                     MetricsRegistry, SeriesView)
from repro_torch.obs.trace import (NULL_SPAN, Span, Tracer,  # noqa: F401
                                   get_tracer, set_tracer, span, tracing)
from repro_torch.obs.numerics import (NUMERICS_SCHEMA,  # noqa: F401
                                      NumericsProbe, NumericsReport,
                                      check_containment, get_probe, probing,
                                      run_numerics, run_program_numerics,
                                      set_probe, snr_rows)
