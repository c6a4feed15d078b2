"""Operation and byte counts from shapes, one file per quantity: K1's
launches (`k1`), K3's launches (`k3`), a model's FLOPs (`model_flops`), and
which host operations are the solvers' (`solvers`).
Each counts what the inputs need, never what an implementation does
again or pads."""
