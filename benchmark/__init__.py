"""The benchmark of ``neojax_torch``: one cell (a deployment under a traffic
mix) run once per call of ``benchmark/run.py``. Everything that measures
lives here: traffic, inputs, the plain reference, the least-work counts and
the trace reduction. From the program it takes only the system under test
(``neojax_torch.conv.Convolver``) and the kernel names of its trace."""
