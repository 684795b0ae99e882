"""A frozen, plain-torch copy of CG's routing and delegation semantics.

It imports nothing of the program (``repro_torch``) nor of the JAX
package, and works out every state from the keys and capacities it is
given. Every function here runs on any device; the benchmark runs it on
the card after the measured window has closed.
"""
