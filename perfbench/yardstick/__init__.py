"""The benchmark's frozen measures: model sizes, FLOP counts, the weight and
token draws, and the reduction of a profiler trace."""
