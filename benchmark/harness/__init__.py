"""The harness: finds a cell's configuration, traffic mix, limits and metric
readers by name, makes the inputs, drives the program, reads the trace and
decides `correct`."""
