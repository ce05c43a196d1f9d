/*
 * rt64tpu_torch C ABI: the public contract of the PyTorch/CUDA renderer.
 *
 * The same header as rt64tpu/abi/rt64_tpu.h, struct for struct and
 * name for name, with the same RT64_LoadLibrary function-pointer table,
 * so a host built against either header binds to either library
 * (librt64tpu.so or librt64tpu_torch.so). It mirrors the reference ABI
 * (public/rt64.h): the same 31 RT64_* entry points, POD descriptor
 * structs and constants, so an sm64rt-style host can switch backends by
 * relinking. Differences from the reference are POSIX-ness only:
 *   - no <Windows.h>; the device is headless. RT64_CreateDevice takes
 *     an opaque pointer (ignored) for signature compatibility.
 *   - presentation is pull-based: RT64_GetViewFramePixels copies the
 *     presented frame (RGBA8) into a host buffer (the swap-chain analog).
 *   - the inspector message hook takes a generic (msg, wparam, lparam)
 *     triple instead of Win32 types.
 * The library draws on the CUDA card, or on the CPU when the environment
 * says RT64TPU_TORCH_DEVICE=cpu; without a card and without that
 * variable RT64_CreateDevice returns NULL and RT64_GetLastError says why.
 */

#ifndef RT64_TPU_H_INCLUDED
#define RT64_TPU_H_INCLUDED

#include <stdbool.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Material constants. */
#define RT64_MATERIAL_FILTER_POINT 0
#define RT64_MATERIAL_FILTER_LINEAR 1
#define RT64_MATERIAL_ADDR_WRAP 0
#define RT64_MATERIAL_ADDR_MIRROR 1
#define RT64_MATERIAL_ADDR_CLAMP 2

/* Material attribute bits. */
#define RT64_ATTRIBUTE_NONE 0x0000
#define RT64_ATTRIBUTE_IGNORE_NORMAL_FACTOR 0x0001
#define RT64_ATTRIBUTE_UV_DETAIL_SCALE 0x0002
#define RT64_ATTRIBUTE_REFLECTION_FACTOR 0x0004
#define RT64_ATTRIBUTE_REFLECTION_FRESNEL_FACTOR 0x0008
#define RT64_ATTRIBUTE_REFLECTION_SHINE_FACTOR 0x0010
#define RT64_ATTRIBUTE_REFRACTION_FACTOR 0x0020
#define RT64_ATTRIBUTE_SPECULAR_COLOR 0x0040
#define RT64_ATTRIBUTE_SPECULAR_EXPONENT 0x0080
#define RT64_ATTRIBUTE_SOLID_ALPHA_MULTIPLIER 0x0100
#define RT64_ATTRIBUTE_SHADOW_ALPHA_MULTIPLIER 0x0200
#define RT64_ATTRIBUTE_DEPTH_BIAS 0x0400
#define RT64_ATTRIBUTE_SHADOW_RAY_BIAS 0x0800
#define RT64_ATTRIBUTE_SELF_LIGHT 0x1000
#define RT64_ATTRIBUTE_LIGHT_GROUP_MASK_BITS 0x2000
#define RT64_ATTRIBUTE_DIFFUSE_COLOR_MIX 0x4000

/* Mesh flags. */
#define RT64_MESH_RAYTRACE_ENABLED 0x1
#define RT64_MESH_RAYTRACE_UPDATABLE 0x2
#define RT64_MESH_RAYTRACE_FAST_TRACE 0x4
#define RT64_MESH_RAYTRACE_COMPACT 0x8

/* Shader flags. */
#define RT64_SHADER_FILTER_POINT 0x0
#define RT64_SHADER_FILTER_LINEAR 0x1
#define RT64_SHADER_ADDRESSING_WRAP 0x0
#define RT64_SHADER_ADDRESSING_MIRROR 0x1
#define RT64_SHADER_ADDRESSING_CLAMP 0x2
#define RT64_SHADER_RASTER_ENABLED 0x1
#define RT64_SHADER_RAYTRACE_ENABLED 0x2
#define RT64_SHADER_NORMAL_MAP_ENABLED 0x4
#define RT64_SHADER_SPECULAR_MAP_ENABLED 0x8

/* Instance flags. */
#define RT64_INSTANCE_RASTER_BACKGROUND 0x1
#define RT64_INSTANCE_DISABLE_BACKFACE_CULLING 0x2

/* Light constants. */
#define RT64_LIGHT_GROUP_MASK_ALL 0xFFFFFFFF
#define RT64_LIGHT_GROUP_DEFAULT 0x1
#define RT64_LIGHT_MAX_SAMPLES 128

/* Upscaler constants. */
#define RT64_UPSCALER_OFF 0x0
#define RT64_UPSCALER_AUTO 0x1
#define RT64_UPSCALER_DLSS 0x2
#define RT64_UPSCALER_FSR 0x3
#define RT64_UPSCALER_XESS 0x4
#define RT64_UPSCALER_MODE_AUTO 0x0
#define RT64_UPSCALER_MODE_ULTRA_PERFORMANCE 0x1
#define RT64_UPSCALER_MODE_PERFORMANCE 0x2
#define RT64_UPSCALER_MODE_BALANCED 0x3
#define RT64_UPSCALER_MODE_QUALITY 0x4
#define RT64_UPSCALER_MODE_ULTRA_QUALITY 0x5
#define RT64_UPSCALER_MODE_NATIVE 0x6

/* Texture formats. */
#define RT64_TEXTURE_FORMAT_RGBA8 0x1
#define RT64_TEXTURE_FORMAT_DDS 0x2

typedef struct RT64_DEVICE RT64_DEVICE;
typedef struct RT64_VIEW RT64_VIEW;
typedef struct RT64_SCENE RT64_SCENE;
typedef struct RT64_INSTANCE RT64_INSTANCE;
typedef struct RT64_MESH RT64_MESH;
typedef struct RT64_TEXTURE RT64_TEXTURE;
typedef struct RT64_SHADER RT64_SHADER;
typedef struct RT64_INSPECTOR RT64_INSPECTOR;

typedef struct { float x, y; } RT64_VECTOR2;
typedef struct { float x, y, z; } RT64_VECTOR3;
typedef struct { float x, y, z, w; } RT64_VECTOR4;
typedef struct { float m[4][4]; } RT64_MATRIX4;
typedef struct { int x, y, w, h; } RT64_RECT;

typedef struct {
    int diffuseTexIndex;
    int normalTexIndex;
    int specularTexIndex;
    float ignoreNormalFactor;
    float uvDetailScale;
    float reflectionFactor;
    float reflectionFresnelFactor;
    float reflectionShineFactor;
    float refractionFactor;
    RT64_VECTOR3 specularColor;
    float specularExponent;
    float solidAlphaMultiplier;
    float shadowAlphaMultiplier;
    float depthBias;
    float shadowRayBias;
    RT64_VECTOR3 selfLight;
    unsigned int lightGroupMaskBits;
    RT64_VECTOR3 fogColor;
    RT64_VECTOR4 diffuseColorMix;
    float fogMul;
    float fogOffset;
    unsigned int fogEnabled;
    float lockMask;
    int enabledAttributes;
} RT64_MATERIAL;

typedef struct {
    RT64_VECTOR3 position;
    RT64_VECTOR3 diffuseColor;
    float attenuationRadius;
    float pointRadius;
    RT64_VECTOR3 specularColor;
    float shadowOffset;
    float attenuationExponent;
    float flickerIntensity;
    unsigned int groupBits;
} RT64_LIGHT;

typedef struct {
    RT64_VECTOR3 ambientBaseColor;
    RT64_VECTOR3 ambientNoGIColor;
    RT64_VECTOR3 eyeLightDiffuseColor;
    RT64_VECTOR3 eyeLightSpecularColor;
    RT64_VECTOR3 skyDiffuseMultiplier;
    RT64_VECTOR3 skyHSLModifier;
    float skyYawOffset;
    float giDiffuseStrength;
    float giSkyStrength;
} RT64_SCENE_DESC;

typedef struct {
    float resolutionScale;
    float motionBlurStrength;
    unsigned int diSamples;
    unsigned int giSamples;
    unsigned int maxLights;
    unsigned char upscaler;
    unsigned char upscalerMode;
    float upscalerSharpness;
    bool denoiserEnabled;
} RT64_VIEW_DESC;

typedef struct {
    RT64_MESH *mesh;
    RT64_MATRIX4 transform;
    RT64_MATRIX4 previousTransform;
    RT64_TEXTURE *diffuseTexture;
    RT64_TEXTURE *normalTexture;
    RT64_TEXTURE *specularTexture;
    RT64_SHADER *shader;
    RT64_MATERIAL material;
    RT64_RECT scissorRect;
    RT64_RECT viewportRect;
    unsigned int flags;
} RT64_INSTANCE_DESC;

typedef struct {
    void *bytes;
    int byteCount;
    int format;
    int width;
    int height;
    int rowPitch;
} RT64_TEXTURE_DESC;

/* Exported entry points (the reference's DLLEXPORT set). */
const char *RT64_GetLastError(void);
RT64_DEVICE *RT64_CreateDevice(void *window);
void RT64_DestroyDevice(RT64_DEVICE *device);
void RT64_DrawDevice(RT64_DEVICE *device, int vsyncInterval, float deltaTimeMs);

RT64_VIEW *RT64_CreateView(RT64_SCENE *scene);
void RT64_SetViewPerspective(RT64_VIEW *view, RT64_MATRIX4 viewMatrix,
                             float fovRadians, float nearDist, float farDist,
                             bool canReproject);
void RT64_SetViewDescription(RT64_VIEW *view, RT64_VIEW_DESC viewDesc);
void RT64_SetViewSkyPlane(RT64_VIEW *view, RT64_TEXTURE *texture);
RT64_INSTANCE *RT64_GetViewRaytracedInstanceAt(RT64_VIEW *view, int x, int y);
bool RT64_GetViewUpscalerSupport(RT64_VIEW *view, char upscaler);
void RT64_DestroyView(RT64_VIEW *view);

RT64_SCENE *RT64_CreateScene(RT64_DEVICE *device);
void RT64_SetSceneDescription(RT64_SCENE *scene, RT64_SCENE_DESC sceneDesc);
void RT64_SetSceneLights(RT64_SCENE *scene, RT64_LIGHT *lightArray, int lightCount);
void RT64_DestroyScene(RT64_SCENE *scene);

RT64_MESH *RT64_CreateMesh(RT64_DEVICE *device, int flags);
void RT64_SetMesh(RT64_MESH *mesh, void *vertexArray, int vertexCount,
                  int vertexStride, unsigned int *indexArray, int indexCount);
void RT64_DestroyMesh(RT64_MESH *mesh);

RT64_SHADER *RT64_CreateShader(RT64_DEVICE *device, unsigned int shaderId,
                               unsigned int filter, unsigned int hAddr,
                               unsigned int vAddr, int flags);
void RT64_DestroyShader(RT64_SHADER *shader);

RT64_INSTANCE *RT64_CreateInstance(RT64_SCENE *scene);
void RT64_SetInstanceDescription(RT64_INSTANCE *instance,
                                 RT64_INSTANCE_DESC instanceDesc);
void RT64_DestroyInstance(RT64_INSTANCE *instance);
/* Extension (additive; absent from rt64.h): binds a real TEXEL1
 * texture where the reference stubs TEXEL1 samples to magenta
 * (rt64_shader.cpp:484-487). NULL unbinds (restores stub parity).
 * Sticky across RT64_SetInstanceDescription calls. */
void RT64_SetInstanceAltTexture(RT64_INSTANCE *instance,
                                RT64_TEXTURE *texture);

RT64_TEXTURE *RT64_CreateTexture(RT64_DEVICE *device, RT64_TEXTURE_DESC desc);
void RT64_DestroyTexture(RT64_TEXTURE *texture);

RT64_INSPECTOR *RT64_CreateInspector(RT64_DEVICE *device);

/* Headless inspector command protocol (the WndProc/ImGui-panel analog,
 * rt64_inspector.cpp:115-353, 461-465). Send msg=RT64TPU_MESSAGE_COMMAND
 * with wParam = (uintptr_t)"command string" and lParam = (intptr_t) a
 * char reply buffer of RT64TPU_INSPECTOR_REPLY_SIZE bytes (or 0).
 * Commands: "get ns.field" / "set ns.field v [v2 v3 v4]" / "list ns" /
 * "camera move dx dy dz" / "camera rotate yaw pitch" / "gizmos on|off" /
 * "dump path|off" / "print msg". Namespaces: material (the struct
 * registered via RT64_SetMaterialInspector — edits WRITE INTO that host
 * struct), scene, light.<i>, view. Returns true when handled; replies
 * start with "ERR " on failure. */
#define RT64TPU_MESSAGE_COMMAND 0x7464u
#define RT64TPU_INSPECTOR_REPLY_SIZE 256
bool RT64_HandleMessageInspector(RT64_INSPECTOR *inspector, unsigned int msg,
                                 unsigned long wParam, long lParam);
void RT64_SetSceneInspector(RT64_INSPECTOR *inspector, RT64_SCENE_DESC *sceneDesc);
void RT64_SetMaterialInspector(RT64_INSPECTOR *inspector, RT64_MATERIAL *material,
                               const char *materialName);
void RT64_SetLightsInspector(RT64_INSPECTOR *inspector, RT64_LIGHT *lights,
                             int *lightCount, int maxLightCount);
void RT64_PrintClearInspector(RT64_INSPECTOR *inspector);
void RT64_PrintMessageInspector(RT64_INSPECTOR *inspector, const char *message);
void RT64_DestroyInspector(RT64_INSPECTOR *inspector);

/* Headless presentation (swap-chain analog): copies the latest RGBA8
 * frame into dst (must hold width*height*4 bytes); returns actual
 * dimensions. */
void RT64_GetViewFrameSize(RT64_VIEW *view, int *width, int *height);
bool RT64_GetViewFramePixels(RT64_VIEW *view, void *dst, size_t dstSize);

/* Header-inline attribute overlay (the rt64.h:207-267 contract): copy
 * into dst exactly the fields whose bits are set in src's
 * enabledAttributes. Hosts compose a base material with per-surface
 * override sets through this before SetInstanceDescription; the
 * Python-side mirror lives in rt64tpu_torch/descriptors.py. */
#define RT64_TPU_ATTR_FIELDS(X)                                     \
    X(RT64_ATTRIBUTE_IGNORE_NORMAL_FACTOR, ignoreNormalFactor)      \
    X(RT64_ATTRIBUTE_UV_DETAIL_SCALE, uvDetailScale)                \
    X(RT64_ATTRIBUTE_REFLECTION_FACTOR, reflectionFactor)           \
    X(RT64_ATTRIBUTE_REFLECTION_FRESNEL_FACTOR, reflectionFresnelFactor) \
    X(RT64_ATTRIBUTE_REFLECTION_SHINE_FACTOR, reflectionShineFactor) \
    X(RT64_ATTRIBUTE_REFRACTION_FACTOR, refractionFactor)           \
    X(RT64_ATTRIBUTE_SPECULAR_COLOR, specularColor)                 \
    X(RT64_ATTRIBUTE_SPECULAR_EXPONENT, specularExponent)           \
    X(RT64_ATTRIBUTE_SOLID_ALPHA_MULTIPLIER, solidAlphaMultiplier)  \
    X(RT64_ATTRIBUTE_SHADOW_ALPHA_MULTIPLIER, shadowAlphaMultiplier) \
    X(RT64_ATTRIBUTE_DEPTH_BIAS, depthBias)                         \
    X(RT64_ATTRIBUTE_SHADOW_RAY_BIAS, shadowRayBias)                \
    X(RT64_ATTRIBUTE_SELF_LIGHT, selfLight)                         \
    X(RT64_ATTRIBUTE_LIGHT_GROUP_MASK_BITS, lightGroupMaskBits)     \
    X(RT64_ATTRIBUTE_DIFFUSE_COLOR_MIX, diffuseColorMix)

static inline void RT64_ApplyMaterialAttributes(RT64_MATERIAL *dst,
                                                RT64_MATERIAL *src) {
#define RT64_TPU_COPY_ATTR(bit, field) \
    if (src->enabledAttributes & (bit)) dst->field = src->field;
    RT64_TPU_ATTR_FIELDS(RT64_TPU_COPY_ATTR)
#undef RT64_TPU_COPY_ATTR
}

/*
 * Runtime binding (the rt64.h:269-342 contract, POSIX-flavored): a
 * function-pointer table over every exported entry point plus a
 * dlopen-based loader, so a reference-style host binds to the backend
 * at runtime without link-time symbols. Define RT64_MINIMAL before
 * including this header to bind only the device-probe subset (the
 * mode sm64rt uses for backend detection); define RT64_TPU_NO_LOADER
 * to get the table type without pulling in <dlfcn.h>.
 *
 * Library search order: $RT64TPU_LIBRARY if set, else "librt64tpu_torch.so"
 * through the normal dynamic-linker path (rpath / LD_LIBRARY_PATH).
 * On failure, .handle is NULL. Check any member before use: a member
 * is NULL when the loaded library predates that entry point.
 */
typedef struct {
    void *handle;
    const char *(*GetLastError)(void);
    RT64_DEVICE *(*CreateDevice)(void *window);
    void (*DestroyDevice)(RT64_DEVICE *device);
#ifndef RT64_MINIMAL
    void (*DrawDevice)(RT64_DEVICE *device, int vsyncInterval,
                       float deltaTimeMs);
    RT64_VIEW *(*CreateView)(RT64_SCENE *scene);
    void (*SetViewPerspective)(RT64_VIEW *view, RT64_MATRIX4 viewMatrix,
                               float fovRadians, float nearDist,
                               float farDist, bool canReproject);
    void (*SetViewDescription)(RT64_VIEW *view, RT64_VIEW_DESC viewDesc);
    void (*SetViewSkyPlane)(RT64_VIEW *view, RT64_TEXTURE *texture);
    RT64_INSTANCE *(*GetViewRaytracedInstanceAt)(RT64_VIEW *view, int x,
                                                 int y);
    bool (*GetViewUpscalerSupport)(RT64_VIEW *view, char upscaler);
    void (*DestroyView)(RT64_VIEW *view);
    RT64_SCENE *(*CreateScene)(RT64_DEVICE *device);
    void (*SetSceneDescription)(RT64_SCENE *scene, RT64_SCENE_DESC sceneDesc);
    void (*SetSceneLights)(RT64_SCENE *scene, RT64_LIGHT *lightArray,
                           int lightCount);
    void (*DestroyScene)(RT64_SCENE *scene);
    RT64_MESH *(*CreateMesh)(RT64_DEVICE *device, int flags);
    void (*SetMesh)(RT64_MESH *mesh, void *vertexArray, int vertexCount,
                    int vertexStride, unsigned int *indexArray,
                    int indexCount);
    void (*DestroyMesh)(RT64_MESH *mesh);
    RT64_SHADER *(*CreateShader)(RT64_DEVICE *device, unsigned int shaderId,
                                 unsigned int filter, unsigned int hAddr,
                                 unsigned int vAddr, int flags);
    void (*DestroyShader)(RT64_SHADER *shader);
    RT64_INSTANCE *(*CreateInstance)(RT64_SCENE *scene);
    void (*SetInstanceDescription)(RT64_INSTANCE *instance,
                                   RT64_INSTANCE_DESC instanceDesc);
    void (*DestroyInstance)(RT64_INSTANCE *instance);
    void (*SetInstanceAltTexture)(RT64_INSTANCE *instance,
                                  RT64_TEXTURE *texture);
    RT64_TEXTURE *(*CreateTexture)(RT64_DEVICE *device,
                                   RT64_TEXTURE_DESC desc);
    void (*DestroyTexture)(RT64_TEXTURE *texture);
    RT64_INSPECTOR *(*CreateInspector)(RT64_DEVICE *device);
    bool (*HandleMessageInspector)(RT64_INSPECTOR *inspector,
                                   unsigned int msg, unsigned long wParam,
                                   long lParam);
    void (*SetSceneInspector)(RT64_INSPECTOR *inspector,
                              RT64_SCENE_DESC *sceneDesc);
    void (*SetMaterialInspector)(RT64_INSPECTOR *inspector,
                                 RT64_MATERIAL *material,
                                 const char *materialName);
    void (*SetLightsInspector)(RT64_INSPECTOR *inspector, RT64_LIGHT *lights,
                               int *lightCount, int maxLightCount);
    void (*PrintClearInspector)(RT64_INSPECTOR *inspector);
    void (*PrintMessageInspector)(RT64_INSPECTOR *inspector,
                                  const char *message);
    void (*DestroyInspector)(RT64_INSPECTOR *inspector);
    void (*GetViewFrameSize)(RT64_VIEW *view, int *width, int *height);
    bool (*GetViewFramePixels)(RT64_VIEW *view, void *dst, size_t dstSize);
#endif /* !RT64_MINIMAL */
} RT64_LIBRARY;

#ifndef RT64_TPU_NO_LOADER

#ifdef __cplusplus
}  /* pause extern "C" for the system includes */
#endif
#include <dlfcn.h>
#include <stdlib.h>
#include <string.h>
#ifdef __cplusplus
extern "C" {
#endif

#ifdef RT64_MINIMAL
#define RT64_TPU_API_LIST(X) X(GetLastError) X(CreateDevice) X(DestroyDevice)
#else
#define RT64_TPU_API_LIST(X)                                          \
    X(GetLastError) X(CreateDevice) X(DestroyDevice) X(DrawDevice)    \
    X(CreateView) X(SetViewPerspective) X(SetViewDescription)         \
    X(SetViewSkyPlane) X(GetViewRaytracedInstanceAt)                  \
    X(GetViewUpscalerSupport) X(DestroyView) X(CreateScene)           \
    X(SetSceneDescription) X(SetSceneLights) X(DestroyScene)          \
    X(CreateMesh) X(SetMesh) X(DestroyMesh) X(CreateShader)           \
    X(DestroyShader) X(CreateInstance) X(SetInstanceDescription)      \
    X(DestroyInstance) X(SetInstanceAltTexture) X(CreateTexture)      \
    X(DestroyTexture) X(CreateInspector) X(HandleMessageInspector)    \
    X(SetSceneInspector) X(SetMaterialInspector) X(SetLightsInspector) \
    X(PrintClearInspector) X(PrintMessageInspector) X(DestroyInspector) \
    X(GetViewFrameSize) X(GetViewFramePixels)
#endif

static inline RT64_LIBRARY RT64_LoadLibrary(void) {
    RT64_LIBRARY lib;
    const char *path;
    memset(&lib, 0, sizeof(lib));
    path = getenv("RT64TPU_LIBRARY");
    lib.handle = dlopen(path != NULL ? path : "librt64tpu_torch.so",
                        RTLD_NOW | RTLD_GLOBAL);
    if (lib.handle == NULL) {
        return lib;
    }
#define RT64_TPU_BIND(name) \
    *(void **)(&lib.name) = dlsym(lib.handle, "RT64_" #name);
    RT64_TPU_API_LIST(RT64_TPU_BIND)
#undef RT64_TPU_BIND
    return lib;
}

static inline void RT64_UnloadLibrary(RT64_LIBRARY *lib) {
    if (lib != NULL && lib->handle != NULL) {
        dlclose(lib->handle);
        memset(lib, 0, sizeof(*lib));
    }
}

#endif /* !RT64_TPU_NO_LOADER */

#ifdef __cplusplus
}
#endif

#endif /* RT64_TPU_H_INCLUDED */
