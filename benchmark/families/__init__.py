"""Families: what the benchmark needs to know of one kind of model.

``run.py`` finds a configuration's family by its ``model_type``: the file
``families/<model_type>.py``, loaded by path as loops and readers are. A
configuration without a ``model_type``, or with one that has no file here,
raises, naming the path looked for. A new kind of model is a new family
file, a plain reference of its own under ``reference/`` and a
configuration file; no file of the harness changes.

A family module provides:

- ``assets(cache_dir)``: writes what the family needs on disk (a stand-in
  vocabulary, say) into ``cache_dir``, a fixed directory inside the
  checkout, once; returns what its ``judge`` is handed, or None.
- ``draw(cfg, seed, device, dtype)``: the state dict for ``seed``, drawn on
  ``device`` in ``dtype``; the same seed gives the same tensors. Both the
  system and the reference are built from it.
- ``System(cfg, state_dict, device, control=None)``: the port's serving
  path for the configuration, with what the traffic loops and
  ``lib.drive.close_window`` use:

  - ``lanes``: the sessions one group of a closed loop holds;
  - ``new_session()``: a session processor (``insert_audio_chunk``,
    ``process_iter_async``, ``finish_async``, ``close``), as the session
    pipeline gets it;
  - ``recorder``: ``attach(proc, sid, fed, due=None)`` before a session's
    first call, with ``fed()`` the samples fed to it so far and ``due(n)``
    when its ``n``-th sample was due (open loops); ``records``, a list of
    ``lib.system.TickRecord`` (or a subclass), one for each tick, whose
    timing fields (``sid``, ``t_prep``, ``t_done``, ``due``, ``fed``,
    ``advanced``) every end-to-end reader uses;
  - ``scheduler.stats()`` (with ``n_failed_ticks``) and
    ``scheduler.reset_stats()``, called at the window's start;
  - ``phase_stats()`` and ``anchor_reasons()``: dicts, empty where the
    family has none;
  - ``close()``: drops every reference to the program's state, before the
    judge runs.

  ``control`` names a lower-precision path of the program; a family that
  has no such path raises for any ``control``.
- ``context(system, cfg)``: the ``lib.context.Context`` fields that are the
  family's: ``max_steps``, ``eot`` and ``tail_frames``.
- ``judge(records, w0, w1, seed, cfg, state_dict, audio_of, tail_frames,
  assets, device, tokens=400, max_sessions=8)``: replays a sample of the
  window's sessions, drawn from the seed with the busiest one in it, with
  the family's plain reference, once the system is closed; ``audio_of(sid,
  n)`` gives the first ``n`` samples a session was fed, ``tail_frames`` is
  ``context``'s. Returns ``lib.judge.verdict``'s dict: ``mean_logit_gap``
  (the number held to the configuration's ``check.mean_logit_gap``),
  ``max_logit_gap``, ``p99_logit_gap``, ``flip_share``,
  ``tokens_compared``, ``sessions`` and ``ticks_replayed``. It raises
  ``ValueError`` for a session it cannot follow.
"""
