"""Request kinds, one module each, found by the traffic mix's
``request``.  A module defines ``Kind(config, traffic, device)`` with

- ``send(spec)``: one request to the program, its result read on the
  host; returns the program calls it made as [(inputs, outputs)];
- ``call``: the program call ``send`` makes (a control or a fault test
  puts something else in its place); ``reference_call(inputs, dtype)``:
  the plain reference of one call, on the same inputs;
- ``paths(spec)``, ``works(spec)``: the simulated paths and the kernel
  work (``work/``) of a request;
- ``compare(sample, seed)``: the numbers that decide ``correct``, from
  the reference on a sample of the completed requests.
"""
