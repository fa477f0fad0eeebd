"""Plain float32 reference of what the benchmark's cells run.

Written in plain PyTorch operations, one image at a time, with TF32 off.
It imports nothing of the measured package: each module names the file of
`excel_tpu_torch` whose arithmetic it restates, quirks included, so that
the two can be read side by side. The reference takes only what the
benchmark made (images, weights, text bank) and works out again whatever
the program derives from them (resized inputs, pseudo-labels, masks).

`Precision` rounds the operands of every matrix product and PAR's storage:
float32 is the reference itself; float8 (e4m3, per-tensor scale) is the
control, the next precision below the configuration's bfloat16.
"""
