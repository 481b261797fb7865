"""Pickle streams in the layouts joblib and scikit-learn use, read and
written with the pickle module alone (the port's machines have neither
package).

Reading: ``RestrictedUnpickler`` restores numpy arrays, dtypes and
scalars, joblib's ``NumpyArrayWrapper`` (an array whose raw bytes follow
its pickle in the file, as ``joblib.dump`` writes every array), the
numpy ufuncs a caller names (a pickled ufunc is a global of
``numpy._core._multiarray_umath`` in numpy 2.0, ``numpy.core.
_multiarray_umath`` in numpy 1, or ``numpy`` itself in later numpy 2
releases) and the stand-in classes a caller maps by (module, name); any
other global is refused before it is called.  Writing: ``GlobalPickler``
writes the stand-in classes a caller names under other (module, name)
globals, the classes a reader with that package restores, without
importing them.
"""

from __future__ import annotations

import pickle
from typing import Dict, Tuple

import numpy as np

NUMPY_CLASSES = {("numpy", "ndarray"), ("numpy", "dtype")} | {
    (mod, name) for mod in ("numpy.core.multiarray", "numpy._core.multiarray")
    for name in ("_reconstruct", "scalar")}
JOBLIB_ARRAY = ("joblib.numpy_pickle", "NumpyArrayWrapper")
UFUNC_MODULES = ("numpy._core._multiarray_umath", "numpy.core._multiarray_umath", "numpy")


class JoblibArray:
    """joblib's NumpyArrayWrapper: an array's subclass, shape, order and
    dtype, whose raw bytes follow its pickle in the file."""

    def read(self, f, what: str) -> np.ndarray:
        if self.dtype.hasobject:
            raise pickle.UnpicklingError(f"{what} holds an object array")
        if getattr(self, "numpy_array_alignment_bytes", None) is not None:
            f.read(int.from_bytes(f.read(1), "little"))      # alignment padding
        count = int(np.prod(self.shape, dtype=np.int64))
        data = f.read(count * self.dtype.itemsize)
        if len(data) != count * self.dtype.itemsize:
            raise pickle.UnpicklingError(f"{what} ends inside its array")
        array = np.frombuffer(data, dtype=self.dtype).copy()
        if self.order == "F":
            return array.reshape(self.shape[::-1]).transpose()
        return array.reshape(self.shape)


class RestrictedUnpickler(pickle._Unpickler):
    """Reads numpy objects, joblib's arrays, the numpy ufuncs named in
    ``ufuncs`` and the classes of ``classes`` ((module, name) -> class);
    ``refuse(module, name)`` raises for any other.  ``what`` names the
    file in errors."""

    def __init__(self, f, what: str, classes: Dict[Tuple[str, str], type] = None,
                 ufuncs: Tuple[str, ...] = ()):
        super().__init__(f)
        self._f, self.what, self.classes = f, what, dict(classes or {})
        for name in ufuncs:
            for module in UFUNC_MODULES:
                self.classes[module, name] = getattr(np, name)

    def refuse(self, module: str, name: str):
        raise pickle.UnpicklingError(f"{self.what} names {module}.{name}")

    def find_class(self, module, name):
        if (module, name) == JOBLIB_ARRAY:
            return JoblibArray
        if (module, name) in NUMPY_CLASSES:
            return super().find_class(module, name)
        if (module, name) in self.classes:
            return self.classes[(module, name)]
        return self.refuse(module, name)

    def load_build(self):
        super().load_build()
        if isinstance(self.stack[-1], JoblibArray):
            self.stack.append(self.stack.pop().read(self._f, self.what))

    dispatch = dict(pickle._Unpickler.dispatch)
    dispatch[pickle.BUILD[0]] = load_build


class GlobalPickler(pickle._Pickler):
    """Protocol 4 pickler that writes each class of ``names`` (class ->
    (module, name)) as that global; every other object pickles as usual."""

    def __init__(self, f, names: Dict[type, Tuple[str, str]]):
        super().__init__(f, protocol=4)
        self.names = dict(names)

    def save_global(self, obj, name=None):
        if obj not in self.names:
            return super().save_global(obj, name)
        module, qualname = self.names[obj]
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)
