"""The benchmark's plain reference: frozen copies of the host miner, the
containment oracle and the synthetic generators of GTRACE-RS.

These modules are pure Python and import nothing of the program under
test, of ``jax`` or of the JAX package; ``bench_port/tests`` holds an AST
scan that keeps it so.  They are copies, not imports, so that a later
change to the program cannot move the yardstick it is judged by:

* ``graphseq``, ``compile``, ``canonical``, ``union_graph``,
  ``enumerate_host``, ``gtrace``, ``reverse_search``, ``containment``:
  the data model, the host GTRACE-RS miner (``mine_gtrace_rs``) and the
  Def. 4 containment oracle (``contains``);
* ``synthetic``: the paper's Table 3 generator, which makes every DB and
  query pool;
* ``control``: the reference with one exactness guarantee broken, the
  control that the comparison has to fail.
"""
