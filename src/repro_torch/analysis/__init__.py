"""repro_torch.analysis -- the port's static analysis and runtime
sanitizers, over the port's own code (the counterpart of the JAX
package's ``repro.analysis``).

* ``repro_torch.analysis.lint`` -- an AST lint engine, run as ``python
  -m repro_torch.analysis.lint src/repro_torch chip_smoke.py`` against a
  checked-in baseline (``analysis/baseline_torch.json``) that ratchets:
  new findings fail, existing ones are triaged or suppressed inline
  (``# lint: ignore[rule] -- reason``).  Rule families:

    - lock discipline  (``locks``, the reference's rules unchanged);
    - eager-PyTorch hazards, the port's imports and its silent
      fallbacks  (``hazards``);
    - kernel conformance: each kernel wrapper with its plain version,
      a CPU test against the reference's oracle and a card check
      (``kernel_oracle``).

* ``repro_torch.analysis.sanitize`` -- opt-in runtime sanitizers
  (``REPRO_SANITIZE=1``): ``make_lock``, the lock factory of every
  lock-bearing module of the port (an order-checked lock with cycle
  detection when sanitizing), and a recompile sentinel on
  ``kernels.ops.set_recompile_hook``.

Import cost: this package is a leaf -- nothing here imports torch or
the serving stack at module scope, so ``make_lock`` stays cheap and
cycle-free.
"""
