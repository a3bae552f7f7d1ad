"""The GLM examples: compressed sensing, the perceptron, phase retrieval,
the door's critical lines, two-layer phase retrieval, universality and
the fast paths."""
