"""Trace-time flags, the port's counterpart of the JAX package's
models/flags.py, as far as the dry run needs one.

The JAX package unrolls its scans for the dry run's FLOP count, because
XLA's cost_analysis counts a while-loop body once. The port's layer,
flash and chunk loops are Python loops, so torch's FlopCounterMode
already counts every iteration and needs no flag. The sLSTM token loop
(models/ssm.py) is the one exception: thousands of steps per layer are
too slow to trace at the production shapes. SLSTM_ONE_STEP makes that
loop trace its first step only (on the ``meta`` device, where no values
exist to get wrong), and launch/dryrun.py adds the other S - 1 steps
analytically, as the JAX package's ``_slstm_correction`` does. Only
``launch.dryrun.measure_totals`` sets it.
"""
SLSTM_ONE_STEP = False


class slstm_one_step:
    def __enter__(self):
        global SLSTM_ONE_STEP
        self._old = SLSTM_ONE_STEP
        SLSTM_ONE_STEP = True

    def __exit__(self, *a):
        global SLSTM_ONE_STEP
        SLSTM_ONE_STEP = self._old
