"""The model behind each configuration, one module a model: a configuration
file's ``"model_module": "<name>"`` is ``models/<name>.py``; one that names
none is ``sequence_generator_cnn``. A new architecture is a new module here,
its plain float32 math under ``reference/`` (which imports neither JAX nor the
port), a configuration file and ``BENCHMARK.json`` entries.

What a module gives the harness, each computed from the configuration's
``model`` entry (``m``) and the benchmark's seeded ``weights``:

- ``leaves(m)``: ``(name, shape, kind)`` of every parameter and buffer, in
  the order they are cut from the seed's draw (``weights.seeded_weights``);
- ``INIT``: each kind's init, ``{kind: f(z)}`` of the leaf's standard-normal
  draw (``weights.INIT`` holds the published models' kinds);
- ``reference_poses(weights, audio, code, m, stat, num_frames=None,
  quant=None)``: the reference's pixel-space poses for (B, L) audio and a
  code (or None), computed in blocks of ``correct.BLOCK`` rows; ``quant`` is
  the control's rounding of every operand;

and, for the kinds ``serve``, ``train_cache`` and ``demo``, which drive the
port's entry points:

- ``KERNELS``: the port's kernels to build before set-up;
- ``port_keys(cfg)``: the port's configuration tree read as the numbers of
  ``m`` that it has to equal;
- ``port_state_dict(weights)``: the weights as the port's generator loads
  them; ``port_parts(state, weights, bank)``: what a train state's ``load``
  takes;
- for a configuration that trains: ``reference_steps(weights, bank, batches,
  m, quant=None)``, the reference's first steps (``{"losses", "grad",
  "change"}``, as ``correct.train_numbers`` compares them),
  ``first_grads(state)``, the port's first gradient of every leaf read from
  its optimizers, and ``changes(state, weights, bank)``, each leaf's change
  since set-up.
"""
