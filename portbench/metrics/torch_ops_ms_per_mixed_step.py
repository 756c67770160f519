"""Device ms of the operations that are not the port's own kernels
(PyTorch's: the gathered chunk attention, norms, RoPE, casts, copies),
per traced step that ran a prefill dispatch: most of a mixed step
beside K1, and a mixed step is what `itl_p90_ms` reads. Steps are told
apart by the harness's span around `Engine.step`."""

from portbench.trace import is_port_kernel


def read(w):
    if w.trace is None or not w.traced:
        return None
    per = w.trace.by_step()
    mixed = [ops for ops, s in zip(per, w.traced_steps())
             if s.prefill_dispatches]
    if len(per) != len(w.traced) or not mixed:
        return None
    s = sum(t for ops in mixed for n, t in ops.items()
            if not is_port_kernel(n))
    return s / len(mixed) * 1e3
